"""The int16-lane instantiations of the port's two DP kernels against
frizbee_tpu's: the plain versions of ``match_units(int16_lanes=True)`` and
``match_units_colstream(int16_lanes=True)`` (which the CUDA kernels'
packed s16x2 instantiations are held against on the card) against the
reference's Pallas kernels with ``int16_lanes=True`` in interpret mode and
against the int32 results; the port's copy of ``score_fits_int16``; the
row-major serving dispatch that puts ASCII typo batches on the int16
kernel; and the refusals.

Inputs are made with numpy from a seed and handed to both packages.
Every comparison has zero tolerance. The reference jit-compiles per typo
budget (the needle length is a run-time scalar), so the cases share one
bucket shape per kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.kernels as jk
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu_torch import Config, datagen, match_topk_batch
from frizbee_tpu_torch import pack_corpus
from frizbee_tpu_torch.ops import batch as tbatch
from frizbee_tpu_torch.ops import colstream as tcs
from frizbee_tpu_torch.ops import kernels as tk

SCORINGS = [tk.DEFAULT_SCORING, (10, 3, 1, 2, 7, 5, 2, 6, 9)]
GR = 1024


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _needle(rng, n, alphabet=6):
    o = rng.integers(97, 97 + alphabet, n).astype(np.int32)
    o = np.where(rng.random(n) < 0.2, o - 32, o)
    f = np.where(o >= 97, o - 32, o + 32)
    return np.concatenate([o, f])


def _rows(rng, B, W, needle, alphabet=6):
    """Rows of 0..W units over the needle's letters with capitals and '/'
    delimiters; a third carry the needle's units in order (some with one
    unit dropped), so the prefilter passes some rows and rejects others."""
    n = needle.shape[0] // 2
    cp = rng.integers(97, 97 + alphabet, (B, W)).astype(np.int32)
    cp = np.where(rng.random((B, W)) < 0.2, cp - 32, cp)
    cp = np.where(rng.random((B, W)) < 0.08, 47, cp)
    nu = rng.integers(0, W + 1, B).astype(np.int32)
    for r in np.nonzero(rng.random(B) < 0.35)[0]:
        units = needle[:n].copy()
        if rng.random() < 0.3:
            units = np.delete(units, rng.integers(0, n))
        m = min(len(units), W)
        nu[r] = max(nu[r], m)
        pos = np.sort(rng.choice(nu[r], m, replace=False))
        cp[r, pos] = units[:m]
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    return cp.astype(np.int8), nu


# ---- score_fits_int16 ---------------------------------------------------

GRID_SCORINGS = [
    tk.DEFAULT_SCORING,
    (10, 3, 1, 2, 7, 5, 2, 6, 9),
    (500, 6, 5, 1, 12, 99, 99, 8, 99),
    (12, 6, 500, 300, 12, 4, 4, 8, 4),
    (200, 6, 30, 20, 12, 40, 40, 8, 30),
]
GRID_N = (1, 2, 8, 16, 17, 24, 32, 33, 48, 64)
GRID_W = (16, 32, 64, 128, 256, 512, 1024)


def _edge_scorings(n, W):
    """Two scorings whose bound plus gap scan is 29999 (inside) and 30000
    (just outside) at (n, W): the default's with the prefix bonus set."""
    m, mm, go, ge, _pre, cap, case, ex, de = tk.DEFAULT_SCORING
    used = n * (m + case + max(cap, de)) + ex + W * (ge + max(go - ge, 0))
    inside = (m, mm, go, ge, 29999 - used, cap, case, ex, de)
    outside = (m, mm, go, ge, 30000 - used, cap, case, ex, de)
    return inside, outside


def test_score_fits_int16_equals_reference_on_grid():
    """The port's copy against the reference's over a grid of scorings,
    needle lengths 1-64 and widths 16-1024, with scorings at the bound's
    edge on every (n, W)."""
    for n in GRID_N:
        for W in GRID_W:
            inside, outside = _edge_scorings(n, W)
            assert tk.score_fits_int16(inside, n, W)
            assert not tk.score_fits_int16(outside, n, W)
            for sc in GRID_SCORINGS + [inside, outside]:
                assert tk.score_fits_int16(sc, n, W) == jk.score_fits_int16(
                    sc, n, W), (sc, n, W)
    # the default scoring fits every needle length and width served
    assert all(tk.score_fits_int16(tk.DEFAULT_SCORING, n, W)
               for n in range(1, 65) for W in GRID_W)


# ---- row-major: match_units ----------------------------------------------

RM_B, RM_W = 300, 128


def _reference_rowmajor(cp, nu, needle, count, T, scoring, int16):
    """The reference's match_units over a 128-wide bucket (no segment
    packing there), int16 or int32 lanes, in interpret mode."""
    out = jk.match_units(
        jnp.asarray(cp), jnp.asarray(nu[:, None]),
        jk.pack_needle_scalars(jnp.asarray(needle), count),
        max_typos=T, scoring=scoring, int16_lanes=int16, interpret=True,
    )
    return np.asarray(out)


@pytest.mark.parametrize("n,T", [(8, 0), (8, 1), (8, 4), (24, 0), (24, 1),
                                 (24, 4)])
def test_match_units_int16_equals_reference_and_int32(n, T):
    """match_units_plain(int16_lanes=True) on a ~300-row W=128 bucket
    equals the reference's int16 instantiation and the port's int32 plain
    version, rejected rows' full-row DP included."""
    rng = np.random.default_rng(600 + 10 * n + T)
    needle = _needle(rng, n)
    cp, nu = _rows(rng, RM_B, RM_W, needle)
    count = RM_B - 23
    scal = tk.pack_needle_scalars(torch.from_numpy(needle[None]), count)
    kw = dict(n=n, max_typos=T, scoring=tk.DEFAULT_SCORING)
    got16 = tk.match_units(torch.from_numpy(cp), torch.from_numpy(nu), scal,
                           int16_lanes=True, **kw)[0].numpy()
    got32 = tk.match_units(torch.from_numpy(cp), torch.from_numpy(nu), scal,
                           **kw)[0].numpy()
    np.testing.assert_array_equal(got16, got32)
    want = _reference_rowmajor(cp, nu, needle, count, T, tk.DEFAULT_SCORING,
                               True)
    np.testing.assert_array_equal(got16[:count], want[:count])
    assert not got16[count:].any()
    assert got16[:count, 0].any() and not got16[:count, 0].all()


def test_match_units_int16_key_emit_through_row_order():
    """Key-emit mode through a row order for two queries, int16 lanes
    against int32, at a second scoring."""
    rng = np.random.default_rng(61)
    n, T, B, W = 20, 4, 256, 64
    needles = np.stack([_needle(rng, n), _needle(rng, n)])
    halves = [_rows(rng, B // 2, W, nd) for nd in needles]
    cp = np.concatenate([h[0] for h in halves])
    nu = np.concatenate([h[1] for h in halves])
    idx = rng.permutation(B).astype(np.int32)
    idx[rng.random(B) < 0.05] = -1
    rows = np.stack([rng.permutation(B) for _ in range(2)]).astype(np.int32)
    scal = tk.pack_needle_scalars(torch.from_numpy(needles), 0)
    scal[:, 0] = torch.tensor([B - 50, 90])
    args = (torch.from_numpy(cp), torch.from_numpy(nu), scal,
            torch.from_numpy(rows), torch.from_numpy(idx))
    kw = dict(n=n, max_typos=T, scoring=SCORINGS[1], idx_bits=9)
    got16 = tk.match_units(*args, int16_lanes=True, **kw)
    got32 = tk.match_units(*args, **kw)
    assert torch.equal(got16, got32)
    assert (got16 != tk.INT64_MAX).any()


# ---- column stream: match_units_colstream ---------------------------------

CS_W, CS_N = 32, 5


def _blocks(cp, nu):
    B, W = cp.shape
    nG = B // GR
    cpT = np.ascontiguousarray(
        cp.reshape(nG, GR, W).transpose(0, 2, 1)).reshape(nG * W, 8, 128)
    return cpT, nu.reshape(nG * 8, 128).astype(np.int32)


def _colstream_case(seed, T):
    rng = np.random.default_rng(seed)
    needles = np.stack([_needle(rng, CS_N, 4) for _ in range(2)])
    cp, nu = _rows(rng, 2 * GR, CS_W, needles[0], alphabet=4)
    cpT, nuT = _blocks(cp, nu)
    idx = rng.permutation(2 * GR).astype(np.int32)
    idx[rng.random(2 * GR) < 0.05] = -1
    return cpT, nuT, needles, idx


def _reference_colstream(cpT, nuT, needles, flags, idx, count, T, int16,
                         idx_bits):
    out = []
    for q in range(needles.shape[0]):
        out.append(jcs.match_units_colstream(
            jnp.asarray(cpT), jnp.asarray(nuT),
            jk.pack_needle_scalars(jnp.asarray(needles[q]), count),
            None if flags is None else jnp.asarray(flags[q]),
            None if idx is None else jnp.asarray(idx.reshape(-1, 128)),
            W=CS_W, n=CS_N, max_typos=T, scoring=tk.DEFAULT_SCORING,
            interpret=True, int16_lanes=int16, idx_bits=idx_bits))
    return out


@pytest.mark.parametrize("T", [0, 1])
def test_colstream_int16_columns_equal_reference_and_int32(T):
    """Five-column mode: the port's int16 plain version equals the
    reference's int16 instantiation, and the reference's int16 equals its
    int32 (the reference's own tests never pin that pair)."""
    cpT, nuT, needles, _idx = _colstream_case(70 + T, T)
    count = 2 * GR
    got = tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT),
        tk.pack_needle_scalars(torch.from_numpy(needles), count),
        W=CS_W, n=CS_N, max_typos=T, scoring=tk.DEFAULT_SCORING,
        int16_lanes=True)
    got32 = tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT),
        tk.pack_needle_scalars(torch.from_numpy(needles), count),
        W=CS_W, n=CS_N, max_typos=T, scoring=tk.DEFAULT_SCORING)
    want16 = _reference_colstream(cpT, nuT, needles, None, None, count, T,
                                  True, 0)
    want32 = _reference_colstream(cpT, nuT, needles, None, None, count, T,
                                  False, 0)
    for q in range(needles.shape[0]):
        for i in range(5):
            np.testing.assert_array_equal(
                got[i][q].numpy(), np.asarray(want16[q][i]),
                err_msg=f"q{q} col{i}")
            np.testing.assert_array_equal(
                np.asarray(want16[q][i]), np.asarray(want32[q][i]),
                err_msg=f"reference int16 vs int32: q{q} col{i}")
            assert torch.equal(got[i][q], got32[i][q])
    assert int(got[0].sum()) > 0


def test_colstream_int16_keys_with_flags_equal_reference():
    """Key-emit mode with dead groups, padding indices and a live count
    that ends inside the second group."""
    T = 1
    cpT, nuT, needles, idx = _colstream_case(80, T)
    flags = np.array([[1, 1], [0, 1]], np.int32)
    count = GR + 300
    got = tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT),
        tk.pack_needle_scalars(torch.from_numpy(needles), count),
        torch.from_numpy(flags), torch.from_numpy(idx),
        W=CS_W, n=CS_N, max_typos=T, scoring=tk.DEFAULT_SCORING,
        idx_bits=11, int16_lanes=True)
    want = _reference_colstream(cpT, nuT, needles, flags, idx, count, T, True,
                                11)
    sent = np.int64(0x7FFFFFFFFFFFFFFF)
    for q, (hi, lo, m) in enumerate(want):
        k = (np.asarray(hi).astype(np.int64) << 32) | (
            np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)
        np.testing.assert_array_equal(got[q].numpy(), k, err_msg=f"q{q}")
        np.testing.assert_array_equal(
            (got[q].numpy() != sent).astype(np.int32), np.asarray(m))
    assert (got[1, :GR].numpy() == sent).all()  # a dead group
    assert (got[0].numpy() != sent).any()


# ---- serving ---------------------------------------------------------------

def test_typo_serving_batch_takes_int16_lanes_and_equals_reference():
    """A row-major typo batch (T=4) over a small ASCII corpus: the port's
    top-k equals frizbee_tpu's ``match_topk_batch``, and every bucket
    launch took the int16 instantiation."""
    hay = datagen.partial_match_corpus(median_length=24, num_samples=3000,
                                       seed=5)
    queries = ["deadbeef", "dEadbeef", "beefdead"]
    for k in tbatch.ROW_MAJOR_LANES:
        tbatch.ROW_MAJOR_LANES[k] = 0
    got = match_topk_batch(queries, pack_corpus(hay, device="cpu"),
                           Config(max_typos=4), k=40)
    assert tbatch.ROW_MAJOR_LANES["int16"] > 0
    assert tbatch.ROW_MAJOR_LANES["int32"] == 0
    want = jm.match_topk_batch(queries, j_pack(hay, unicode=False),
                               JConfig(max_typos=4), k=40)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[0] > 0
        for u, v in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_unicode_typo_serving_batch_stays_int32():
    """Codepoint rows exceed int16: a unicode typo batch takes the int32
    instantiation."""
    hay = datagen.unicode_corpus("arabic", needle="إن", num_samples=600,
                                 seed=3)
    for k in tbatch.ROW_MAJOR_LANES:
        tbatch.ROW_MAJOR_LANES[k] = 0
    out = match_topk_batch(["إنلامافي"], pack_corpus(hay, unicode=True,
                                                     device="cpu"),
                           Config(max_typos=4), k=10)
    assert len(out) == 1
    assert tbatch.ROW_MAJOR_LANES["int32"] > 0
    assert tbatch.ROW_MAJOR_LANES["int16"] == 0


# ---- refusals ----------------------------------------------------------------

def test_int16_lanes_refused_on_codepoints_and_unfit_scorings():
    """int16_lanes=True raises on codepoint rows, on a scoring that
    score_fits_int16 rejects, on negative costs, and in literal mode."""
    rng = np.random.default_rng(9)
    needle = _needle(rng, 8)
    cp, nu = _rows(rng, 64, 64, needle)
    scal = tk.pack_needle_scalars(torch.from_numpy(needle[None]), 64)
    big = (500, 6, 5, 1, 12, 99, 99, 8, 99)
    assert not tk.score_fits_int16(big, 64, 64)
    needle64 = _needle(rng, 64)
    scal64 = tk.pack_needle_scalars(torch.from_numpy(needle64[None]), 64)
    with pytest.raises(ValueError, match="codepoints"):
        tk.match_units(torch.from_numpy(cp.astype(np.int32)),
                       torch.from_numpy(nu), scal, n=8,
                       scoring=tk.DEFAULT_SCORING, int16_lanes=True)
    with pytest.raises(ValueError, match="does not fit"):
        tk.match_units(torch.from_numpy(cp), torch.from_numpy(nu), scal64,
                       n=64, scoring=big, int16_lanes=True)
    with pytest.raises(ValueError, match="does not fit"):
        tk.match_units_plain(torch.from_numpy(cp), torch.from_numpy(nu),
                             scal, n=8, scoring=(12, 6, -5, 1, 12, 4, 4, 8, 4),
                             int16_lanes=True)
    cpT, nuT, needles, _idx = _colstream_case(90, 0)
    cs_scal = tk.pack_needle_scalars(torch.from_numpy(needles), 2 * GR)
    with pytest.raises(ValueError, match="codepoints"):
        tcs.match_units_colstream_plain(
            torch.from_numpy(cpT.astype(np.int32)), torch.from_numpy(nuT),
            cs_scal, W=CS_W, n=CS_N, scoring=tk.DEFAULT_SCORING,
            int16_lanes=True)
    with pytest.raises(ValueError, match="does not fit"):
        tcs.match_units_colstream(
            torch.from_numpy(cpT), torch.from_numpy(nuT), cs_scal, W=CS_W,
            n=CS_N, scoring=(12, 6, 5000, 1000, 12, 4, 4, 8, 4),
            int16_lanes=True)
    with pytest.raises(ValueError, match="fuzzy mode only"):
        tcs.match_units_colstream(
            torch.from_numpy(cpT), torch.from_numpy(nuT), cs_scal, W=CS_W,
            n=CS_N, scoring=tk.DEFAULT_SCORING, mode="substring",
            needle_byte_len=CS_N, int16_lanes=True)
    assert not tk.int16_lanes_fit(True, tk.DEFAULT_SCORING, 8, 64)
    assert tk.int16_lanes_fit(False, tk.DEFAULT_SCORING, 64, 1024)


@pytest.mark.parametrize("W", [16, 32, 64, 128, 256, 512, 1024])
def test_int16_colstream_tile_geometry(W):
    """The int16 colstream kernel's tile: two rows a thread, so a block of
    128, 64 or 32 threads stages twice its rows; every group's rows are
    covered once a query chunk, and shared memory stays within a block's
    227 KB (above 48 KB only where one warp's 64 rows need it)."""
    geo = tcs.tile_geometry(W, 1, 512, 32, rows_per_thread=2)
    assert geo["rows"] == 2 * geo["threads"]
    assert geo["threads"] in (128, 64, 32)
    assert geo["tiles"] * geo["rows"] == 512 * GR
    assert geo["smem"] == geo["rows"] * W
    assert geo["smem"] <= tcs.TILE_BYTES or geo["threads"] == 32
    assert geo["smem"] <= 227 * 1024
    one = tcs.tile_geometry(W, 1, 512, 32)
    assert geo["threads"] in (one["threads"], one["threads"] // 2)
