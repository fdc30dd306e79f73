"""The lane contract of the port (``ops/contract.py``, the plain model
that the CUDA contract kernel ``csrc/lane_contract.cu`` is held to on the
card) and the port code that stands in for the reference's lane
primitives, against frizbee_tpu's lane helpers, in int32 and int16 lanes.

The reference's cross-lane helpers (``_shift_right``, ``_cumsum_lanes``,
``_cummax_lanes``, ``_gather_lane``, ``_rmin``/``_rmax``) run inside an
interpret-mode ``pallas_call``, as ``tests/test_kernel_contract.py`` runs
them; each is held against the port code that computes the same quantity
on the same inputs: the row-major plain version's lane shift, prefix
sums of byte lengths, gap-scan maximum, lane gather and lane reductions,
and the contract model's row walks, which compute the same quantities
with those helpers in int32 and int16 lanes.

The per-thread helpers of the CUDA kernels — byte classes, the UTF-8
context of a codepoint, the bonus bits and context bonus, the serving
key, every s16x2 operation of the int16-lane kernels, and the serial row
walks that compute the lane primitives' quantities on the card — are held
in the contract model against the reference's helpers or an independent
numpy model. Inputs come from numpy seeds; zero tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu.ops.kernels as jk
from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu.ops.presence import _fold_bit as j_fold_bit
from frizbee_tpu_torch.ops import contract as tc
from frizbee_tpu_torch.ops import kernels as tk
from frizbee_tpu_torch.ops.presence import _fold_bit as t_fold_bit

W = 128
LANES = [(jnp.int32, torch.int32), (jnp.int16, torch.int16)]


def run_in_kernel(fn, out_struct, *arrays):
    """``fn`` over whole-array refs inside an interpret-mode pallas_call
    (lane rotates exist only in kernel context)."""
    from jax.experimental import pallas as pl

    n_out = len(out_struct) if isinstance(out_struct, tuple) else 1

    def kernel(*refs):
        outs = fn(*[r[:] for r in refs[:-n_out]])
        if n_out == 1:
            outs = (outs,)
        for ref, o in zip(refs[-n_out:], outs):
            ref[:] = o

    return pl.pallas_call(kernel, out_shape=out_struct, interpret=True)(
        *arrays)


def _col(rows, dtype):
    return jax.lax.broadcasted_iota(jnp.int32, (rows, W), 1).astype(dtype)


@pytest.mark.parametrize("jdt,tdt", LANES)
def test_shift_cumsum_cummax_against_reference_lanes(jdt, tdt):
    """The row-major plain version's lane shift (``kernels._shift_right``),
    gap prefix sum (``torch.cumsum`` in the lane type) and scan maximum
    (``torch.cummax``) against the reference's ``_shift_right``,
    ``_cumsum_lanes`` and ``_cummax_lanes``."""
    rng = np.random.default_rng(3)
    x = rng.integers(-100, 1000, (8, W))
    p = rng.integers(0, 5, (8, W))
    col = _col(8, jdt)
    neg = -(20000 if jdt == jnp.int16 else (1 << 30))
    shift, csum, cmax = run_in_kernel(
        lambda a, b, c: (jk._shift_right(a, 1, -5, c),
                         jk._cumsum_lanes(b, c, W),
                         jk._cummax_lanes(a, c, W, neg)),
        tuple(jax.ShapeDtypeStruct((8, W), jdt) for _ in range(3)),
        jnp.asarray(x, jdt), jnp.asarray(p, jdt), col)
    xt = torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(tk._shift_right(xt, -5).numpy(),
                                  np.asarray(shift))
    np.testing.assert_array_equal(
        torch.cumsum(torch.from_numpy(p).to(tdt), dim=1, dtype=tdt).numpy(),
        np.asarray(csum))
    np.testing.assert_array_equal(torch.cummax(xt, dim=1).values.numpy(),
                                  np.asarray(cmax))


@pytest.mark.parametrize("jdt,tdt", LANES)
def test_gather_and_reductions_against_reference_lanes(jdt, tdt):
    """``kernels._lane_gather``, ``_lane_min`` and ``_lane_max`` against
    the reference's ``_gather_lane``, ``_rmin`` and ``_rmax``."""
    rng = np.random.default_rng(4)
    x = rng.integers(-100, 30000, (8, W))
    idx = rng.integers(0, W, (8, 1))
    got = run_in_kernel(
        lambda a, i, c: jk._gather_lane(a, i, c),
        jax.ShapeDtypeStruct((8, 1), jdt),
        jnp.asarray(x, jdt), jnp.asarray(idx, jdt), _col(8, jdt))
    xt = torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(
        tk._lane_gather(xt, torch.from_numpy(idx[:, 0])).numpy(),
        np.asarray(got)[:, 0])
    xj = jnp.asarray(x, jdt)
    np.testing.assert_array_equal(tk._lane_min(xt).numpy(),
                                  np.asarray(jk._rmin(xj))[:, 0])
    np.testing.assert_array_equal(tk._lane_max(xt).numpy(),
                                  np.asarray(jk._rmax(xj))[:, 0])


@pytest.mark.parametrize("jdt", [jnp.int32, jnp.int16])
def test_unit_context_byte_offsets_against_reference(jdt):
    """The port's ``_unit_context`` (first byte, previous last byte, byte
    offsets from an exclusive prefix sum of byte lengths, lengths, byte
    count) of codepoint rows and byte rows against the reference's, whose
    offsets come from ``_cumsum_lanes``."""
    rng = np.random.default_rng(5)
    pool = np.array([0x41, 0x61, 0x2F, 0xE9, 0x644, 0x20AC, 0xAC00,
                     0x1F600, 0x10348, 0x7F, 0x80, 0x7FF, 0x800])
    rows = 16
    cp = rng.choice(pool, (rows, W))
    nu = rng.integers(0, W + 1, rows)
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    for unicode in (True, False):
        hay = cp if unicode else cp & 0x7F
        col = _col(rows, jdt)
        valid = col < jnp.asarray(nu[:, None], jnp.int32).astype(jdt)
        want = run_in_kernel(
            lambda h, v, c: jk._unit_context(h, v, c, W, unicode, jdt),
            tuple(jax.ShapeDtypeStruct(s, jdt)
                  for s in ((rows, W),) * 4 + ((rows, 1),)),
            jnp.asarray(hay, jnp.int32), valid, col)
        hay_t = torch.from_numpy(hay.astype(np.int32 if unicode else np.int8))
        valid_t = torch.from_numpy(np.arange(W)[None, :] < nu[:, None])
        col_t = torch.arange(W, dtype=torch.int32)[None, :]
        got = tk._unit_context(hay_t, valid_t, col_t)
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = g.numpy()
            if i == 4:
                w = w[:, 0]
            if i in (0, 1):  # the reference leaves lanes past the row free
                g, w = g[valid_t.numpy()], w[valid_t.numpy()]
            np.testing.assert_array_equal(g, w, err_msg=f"field {i}")


def test_fold_bit_against_reference():
    v = np.arange(0x300, dtype=np.int32)
    np.testing.assert_array_equal(
        t_fold_bit(torch.from_numpy(v)).numpy(),
        np.asarray(j_fold_bit(jnp.asarray(v))))


def test_score_fits_int16_against_reference():
    for sc in [tk.DEFAULT_SCORING, (500, 6, 5, 1, 12, 99, 99, 8, 99),
               (12, 6, 500, 300, 12, 4, 4, 8, 4)]:
        for n, w in ((8, 128), (64, 1024), (64, 128), (4, 128)):
            assert tk.score_fits_int16(sc, n, w) == jk.score_fits_int16(
                sc, n, w)


@pytest.fixture(scope="module")
def contract():
    ins = tc.contract_inputs(seed=7)
    return ins, tc.contract_plain(*ins, tk.DEFAULT_SCORING)


@pytest.mark.parametrize("t", [0, 1], ids=["int32", "int16"])
def test_contract_rows_against_reference_lanes(contract, t):
    """The model's row walks, the quantities the contract kernel computes
    per row in int32 and int16 arithmetic, against the reference's lane
    primitives in the same lane type: ``_shift_right`` at each (distance,
    fill), ``_cumsum_lanes``, ``_cummax_lanes``, ``_gather_lane``,
    ``_rmin``/``_rmax`` and ``_unit_context`` of byte and codepoint rows."""
    (_u, _p, _k, _w, rows, args), (_uo, _po, _ko, _wo, r_out) = contract
    jdt = LANES[t][0]
    x, p, u = (rows[:, i].numpy() for i in range(3))
    a = args.numpy()
    got = r_out[t].numpy()
    R, L = x.shape
    assert L == W
    col = _col(R, jdt)
    xj, pj = jnp.asarray(x, jdt), jnp.asarray(p, jdt)
    for d, fill in tc.SHIFTS:
        sel = a[:, 0] == d
        want = run_in_kernel(lambda v, c: jk._shift_right(v, d, fill, c),
                             jax.ShapeDtypeStruct((R, W), jdt), xj, col)
        np.testing.assert_array_equal(got[sel, :W], np.asarray(want)[sel],
                                      err_msg=f"shift {d}")
    neg = -(20000 if jdt == jnp.int16 else (1 << 30))
    csum, cmax, at = run_in_kernel(
        lambda v, q, i, c: (jk._cumsum_lanes(q, c, W),
                            jk._cummax_lanes(v, c, W, neg),
                            jk._gather_lane(v, i, c)),
        (jax.ShapeDtypeStruct((R, W), jdt), jax.ShapeDtypeStruct((R, W), jdt),
         jax.ShapeDtypeStruct((R, 1), jdt)),
        xj, pj, jnp.asarray(a[:, 2:3], jdt), col)
    np.testing.assert_array_equal(got[:, W:2 * W], np.asarray(csum))
    np.testing.assert_array_equal(got[:, 2 * W:3 * W], np.asarray(cmax))
    np.testing.assert_array_equal(got[:, 7 * W], np.asarray(at)[:, 0])
    np.testing.assert_array_equal(got[:, 7 * W + 1],
                                  np.asarray(jk._rmin(xj))[:, 0])
    np.testing.assert_array_equal(got[:, 7 * W + 2],
                                  np.asarray(jk._rmax(xj))[:, 0])
    valid_np = np.arange(W)[None, :] < a[:, 3:4]
    valid = col < jnp.asarray(a[:, 3:4], jnp.int32).astype(jdt)
    for unicode in (True, False):
        sel = (a[:, 4] != 0) == unicode
        hay = u if unicode else u & 0xFF
        want = run_in_kernel(
            lambda h, v, c: jk._unit_context(h, v, c, W, unicode, jdt),
            tuple(jax.ShapeDtypeStruct(s, jdt)
                  for s in ((R, W),) * 4 + ((R, 1),)),
            jnp.asarray(hay, jnp.int32), valid, col)
        first, prev, boff, blen, nb = (np.asarray(w)[sel] for w in want)
        g = got[sel]
        v = valid_np[sel]
        # the reference's byte rows keep their first byte past the row
        np.testing.assert_array_equal(g[:, 3 * W:4 * W][v], first[v])
        for i, field in ((4, prev), (5, boff), (6, blen)):
            np.testing.assert_array_equal(g[:, i * W:(i + 1) * W], field,
                                          err_msg=f"{unicode} field {i}")
        np.testing.assert_array_equal(g[:, 7 * W + 3], nb[:, 0])
    # both kinds of row, both edges of the unit count, and every distance
    assert {0, W} <= set(a[:, 3].tolist()) and set(a[:, 4]) == {0, 1}
    assert {d for d, _ in tc.SHIFTS} == set(a[:, 0].tolist())


def test_contract_units_and_pairs_against_reference(contract):
    """The model's byte classes, byte and codepoint ctx facts, bonus bits
    and context bonus against the reference's colstream ``_bonus_bits``
    over its UTF-8 context (``_utf8_ctx``) and its delimiter rule."""
    (units, pairs, _k, _w, _r, _a), (u_out, p_out, _ko, _wo, _ro) = contract
    c = units.numpy()
    cj = jnp.asarray(c)
    first, last, blen = jcs._utf8_ctx(cj, jnp.ones(c.shape, jnp.bool_))
    want_cp = np.asarray(jcs._bonus_bits(first, last)) | (
        np.asarray(blen) << 4)
    np.testing.assert_array_equal(u_out[:, 4].numpy(), want_cp)
    np.testing.assert_array_equal(u_out[:, 5].numpy(), np.asarray(blen))
    want_byte = np.asarray(jcs._bonus_bits(cj, cj)) | 16
    np.testing.assert_array_equal(u_out[:, 3].numpy(), want_byte)
    np.testing.assert_array_equal(u_out[:, 0].numpy(),
                                  (c >= 0x41) & (c <= 0x5A))
    np.testing.assert_array_equal(u_out[:, 1].numpy(),
                                  (c >= 0x61) & (c <= 0x7A))
    np.testing.assert_array_equal(u_out[:, 2].numpy(),
                                  (want_byte & 2) > 0)
    x, y = pairs[:, 0].numpy(), pairs[:, 1].numpy()
    np.testing.assert_array_equal(
        p_out[:, 0].numpy(),
        np.asarray(jcs._bonus_bits(jnp.asarray(x), jnp.asarray(y))))
    cap, delim = tk.DEFAULT_SCORING[5], tk.DEFAULT_SCORING[8]
    want = (np.where((x & 1) & ((y >> 2) & 1), cap, 0)
            + np.where(((y >> 3) & 1) & ~((x >> 1) & 1), delim, 0))
    np.testing.assert_array_equal(p_out[:, 1].numpy(), want)


def test_contract_keys_against_reference(contract):
    """The model's serving keys against the reference's key packing
    (``ops/batch._keys_from_cols``), per index width."""
    (_u, _p, keys, _w, _r, _a), (_uo, _po, k_out, _wo, _ro) = contract
    k = keys.numpy()
    for bits in np.unique(k[:, 6]):
        sel = k[:, 6] == bits
        ks = k[sel]
        want, _cnt = jbatch._keys_from_cols(
            jnp.asarray(ks[:, 0] > 0), jnp.asarray(ks[:, 1]),
            jnp.asarray(ks[:, 2] > 0), jnp.asarray(ks[:, 3]),
            jnp.asarray(ks[:, 4] > 0), jnp.asarray(ks[:, 5]), int(bits))
        np.testing.assert_array_equal(k_out[sel].numpy(), np.asarray(want))


def test_contract_s16x2_words_against_numpy_int16(contract):
    """The model's s16x2 operations against numpy int16 lanes (two's
    complement adds that wrap): add-max with and without relu, max3,
    bmax with its predicates, the half masks, the half packing, the
    per-half select, the match score, the DP cell and the running best
    with the halves it raised."""
    (_u, _p, _k, words, _r, _a), (_uo, _po, _ko, w_out, _ro) = contract
    w = words.numpy().view(np.uint32).astype(np.uint64)
    out = w_out.numpy().view(np.uint32)

    def halves(x):
        x = x.astype(np.uint32)
        return np.stack([(x & 0xFFFF).astype(np.uint16).view(np.int16),
                         (x >> 16).astype(np.uint16).view(np.int16)], -1)

    def packed(h):
        h = h.astype(np.int16).view(np.uint16).astype(np.uint32)
        return h[..., 0] | (h[..., 1] << 16)

    a, b, c, d, e, f = (halves(w[:, i]) for i in range(6))
    k = w[:, 6].astype(np.int64)
    with np.errstate(over="ignore"):
        addmax = np.maximum(a + b, c)
        cell = np.maximum(a + b, np.maximum(c + d, np.maximum(e + f, 0)))
    zero = np.zeros_like(a)
    want = {
        0: packed(addmax),
        1: packed(np.maximum(addmax, zero)),
        2: packed(np.maximum(np.maximum(a, b), c)),
        3: packed(np.maximum(np.maximum(np.maximum(a, b), c), zero)),
        4: packed(np.maximum(a, b)),
        5: ((a[:, 0] >= b[:, 0]).astype(np.uint32)
            | ((a[:, 1] >= b[:, 1]).astype(np.uint32) << 1)),
        12: packed(cell),
    }
    for col, exp in want.items():
        np.testing.assert_array_equal(out[:, col], exp, err_msg=f"op {col}")

    def hmask(lo_bit, hi_bit):
        return (lo_bit * 0xFFFF) | ((hi_bit * 0xFFFF) << 16)

    wa, wb, wc, wd, we = (w[:, i].astype(np.uint64) for i in range(5))
    k31, k15, k63 = k & 31, k & 15, k & 63
    bit = lambda x, i: ((x >> i.astype(np.uint64)) & 1).astype(np.uint32)
    np.testing.assert_array_equal(out[:, 6], hmask(bit(wa, k31), bit(wb, k31)))
    np.testing.assert_array_equal(out[:, 7],
                                  hmask(bit(wa, k15), bit(wa, k15 + 16)))
    p16 = (wa & 0xFFFF) | ((wb & 0xFFFF) << 16)
    np.testing.assert_array_equal(out[:, 8], p16.astype(np.uint32))
    np.testing.assert_array_equal(
        out[:, 9], ((wa >> 16) | ((wb >> 16) << 16)).astype(np.uint32))
    sel = lambda m, x, y: ((x & m) | (y & ~m & 0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(out[:, 10], sel(wc, wa, wb))
    np.testing.assert_array_equal(
        out[:, 11], sel(wa, sel(wb, wc, wd).astype(np.uint64), we))
    lo64, hi64 = wa | (wb << 32), wc | (wd << 32)
    np.testing.assert_array_equal(out[:, 13],
                                  hmask(bit(lo64, k63), bit(hi64, k63)))
    np.testing.assert_array_equal(out[:, 14],
                                  hmask(bit(wa, k15), bit(wb, k15)))
    np.testing.assert_array_equal(out[:, 15], packed(np.maximum(a, b)))
    np.testing.assert_array_equal(
        out[:, 16], (b[:, 0] > a[:, 0]).astype(np.uint32)
        | ((b[:, 1] > a[:, 1]).astype(np.uint32) << 1))
    # the edges of the DP's reach, and sums that cross +-32767, are there
    lo = a[:, 0].astype(np.int64) + b[:, 0]
    assert (lo > 32767).any() and (lo < -32768).any()
    assert set(tc.INT16_EDGES) <= set(a[:, 0].tolist())


def test_lane_contract_dispatch_on_cpu(contract):
    """On CPU tensors the wrapper is the plain model."""
    ins, want = contract
    got = tc.lane_contract(*ins, tk.DEFAULT_SCORING)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
