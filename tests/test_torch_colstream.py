"""The port's column-stream kernel (plain PyTorch version, which the CUDA
kernel is held against on the card) and its row gather, against
frizbee_tpu's Pallas kernels run in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Integer outputs are compared with zero tolerance: the five result
columns, and in key-emit mode the int64 key against the reference's
(hi << 32) | lo halves."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu.ops.kernels import pack_needle_scalars as j_pack_scalars
from frizbee_tpu_torch.ops import _build
from frizbee_tpu_torch.ops import colstream as tcs
from frizbee_tpu_torch.ops.kernels import (
    DEFAULT_SCORING,
    pack_needle_scalars,
)

GR = 1024
SCORINGS = [DEFAULT_SCORING, (10, 3, 1, 2, 7, 5, 2, 6, 9)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _blocks(cp, nu):
    """(cpT (nG*W, 8, 128) int8, nuT (nG*8, 128) int32) from row-major
    (B, W) bytes, B a multiple of 1024."""
    B, W = cp.shape
    nG = B // GR
    cpT = np.ascontiguousarray(
        cp.reshape(nG, GR, W).transpose(0, 2, 1)
    ).reshape(nG * W, 8, 128)
    return cpT, nu.reshape(nG * 8, 128).astype(np.int32)


def _uneven_rows(rng, nG, W, alphabet=6):
    """Random rows whose lengths swing from 0 to W inside every group,
    with capitals and '/' delimiters mixed in."""
    B = nG * GR
    cp = rng.integers(97, 97 + alphabet, (B, W)).astype(np.int32)
    nu = np.where(
        rng.random(B) < 0.5,
        rng.integers(0, 6, B), rng.integers(0, W + 1, B),
    ).astype(np.int32)
    cp = np.where(rng.random((B, W)) < 0.15, cp - 32, cp)
    cp = np.where(rng.random((B, W)) < 0.1, 47, cp)
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    return cp.astype(np.int8), nu


def _needles(rng, Q, n, alphabet=6):
    o = rng.integers(97, 97 + alphabet, (Q, n)).astype(np.int32)
    o = np.where(rng.random((Q, n)) < 0.2, o - 32, o)
    f = np.where(o >= 97, o - 32, o + 32)
    return np.concatenate([o, f], axis=1)


def _run_both(cpT, nuT, needles, flags, idxT, count, *, W, n, T, no_pre,
              scoring=DEFAULT_SCORING, idx_bits=0):
    """(reference per query, port batched) outputs as numpy."""
    kw = dict(W=W, n=n, max_typos=T, scoring=scoring, no_prefilter=no_pre)
    got = tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT),
        pack_needle_scalars(torch.from_numpy(needles), count),
        None if flags is None else torch.from_numpy(flags),
        None if idxT is None else torch.from_numpy(idxT),
        idx_bits=idx_bits, **kw,
    )
    want = []
    for q in range(needles.shape[0]):
        want.append(jcs.match_units_colstream(
            jnp.asarray(cpT), jnp.asarray(nuT),
            j_pack_scalars(jnp.asarray(needles[q]), count),
            None if flags is None else jnp.asarray(flags[q]),
            None if idxT is None else jnp.asarray(idxT.reshape(-1, 128)),
            interpret=True, idx_bits=idx_bits, **kw,
        ))
    return want, got


def _assert_cols_equal(want, got):
    for q, w in enumerate(want):
        for i in range(5):
            np.testing.assert_array_equal(
                got[i][q].numpy(), np.asarray(w[i]), err_msg=f"q{q} col{i}"
            )


def _assert_keys_equal(want, got):
    sent = np.int64(0x7FFFFFFFFFFFFFFF)
    for q, (hi, lo, m) in enumerate(want):
        k = (np.asarray(hi).astype(np.int64) << 32) | (
            np.asarray(lo).astype(np.int64) & 0xFFFFFFFF
        )
        np.testing.assert_array_equal(got[q].numpy(), k, err_msg=f"q{q}")
        np.testing.assert_array_equal(
            (got[q].numpy() != sent).astype(np.int32), np.asarray(m)
        )


@pytest.mark.parametrize(
    "T,no_pre", [(0, False), (1, False), (2, False), (3, False), (0, True)]
)
def test_columns_uneven_rows(T, no_pre):
    """Five-column mode, two groups whose rows range from empty to the
    full width: the port walks each row only to its own length, the
    reference to the group maximum."""
    rng = np.random.default_rng(10 + T + (5 if no_pre else 0))
    W, n = 32, 5
    cp, nu = _uneven_rows(rng, 2, W)
    cpT, nuT = _blocks(cp, nu)
    needles = _needles(rng, 2, n)
    want, got = _run_both(cpT, nuT, needles, None, None, cp.shape[0],
                          W=W, n=n, T=T, no_pre=no_pre,
                          scoring=SCORINGS[T % 2])
    _assert_cols_equal(want, got)
    assert int(got[0].sum()) > 0  # some rows match


@pytest.mark.parametrize("T,no_pre", [(0, False), (2, False), (0, True)])
def test_key_emit_with_mixed_flags(T, no_pre):
    """Key-emit mode with alive and dead groups, padding rows (index -1)
    and a live-row count that ends inside the last group."""
    rng = np.random.default_rng(40 + T)
    W, n = 16, 4
    cp, nu = _uneven_rows(rng, 3, W, alphabet=4)
    cpT, nuT = _blocks(cp, nu)
    idx = rng.permutation(3 * GR).astype(np.int32)
    idx[rng.random(3 * GR) < 0.05] = -1
    needles = _needles(rng, 2, n, alphabet=4)
    flags = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    want, got = _run_both(cpT, nuT, needles, flags, idx, 2 * GR + 100,
                          W=W, n=n, T=T, no_pre=no_pre, idx_bits=12)
    _assert_keys_equal(want, got)
    sent = np.int64(0x7FFFFFFFFFFFFFFF)
    assert (got[0][GR:2 * GR].numpy() == sent).all()  # dead group
    assert (got[0].numpy() != sent).any()


def test_exact_prefix_and_capitalization_rows():
    """Rows equal to the needle (exact bonus), case flips, prefixes,
    delimiter and capitalization context, short and empty rows."""
    needle = np.frombuffer(b"DeadBeef", np.uint8).astype(np.int32)
    flip = np.where(
        (needle >= 65) & (needle <= 90), needle + 32,
        np.where((needle >= 97) & (needle <= 122), needle - 32, needle),
    )
    rows = [
        b"DeadBeef", b"deadbeef", b"xDeadBeefx", b"", b"Dead/Beef",
        b"DEADBEEF", b"DeadBee", b"aDeadBeef", b"dead_beef_DeadBeef",
        b"De-ad-Be-ef", b"xxDxexaxdxBxexexf", b"DeadBeefDeadBeef",
    ]
    W = 32
    cp = np.zeros((GR, W), np.int8)
    nu = np.zeros(GR, np.int32)
    for i, r in enumerate(rows):
        cp[i, : len(r)] = np.frombuffer(r, np.uint8).astype(np.int8)
        nu[i] = len(r)
    cpT, nuT = _blocks(cp, nu)
    needles = np.concatenate([needle, flip])[None, :]
    for T in (0, 1):
        want, got = _run_both(cpT, nuT, needles, None, None, GR,
                              W=W, n=8, T=T, no_pre=False)
        _assert_cols_equal(want, got)
        assert got[2][0, 0] == 1 and got[2][0, 1] == 0  # exact bit
        assert got[1][0, 0] > got[1][0, 1]  # exact + case bonuses


def test_auto_match_needle_within_budget():
    """n <= max_typos: every row passes with its full-row window."""
    rng = np.random.default_rng(3)
    cp, nu = _uneven_rows(rng, 1, 16, alphabet=3)
    cpT, nuT = _blocks(cp, nu)
    needles = _needles(rng, 1, 2)
    want, got = _run_both(cpT, nuT, needles, None, None, GR,
                          W=16, n=2, T=3, no_pre=False)
    _assert_cols_equal(want, got)
    assert bool(got[0].all())


def test_pack_needle_scalars_layout():
    rng = np.random.default_rng(5)
    needles = _needles(rng, 3, 7)
    got = pack_needle_scalars(torch.from_numpy(needles), 777).numpy()
    for q in range(3):
        np.testing.assert_array_equal(
            got[q], np.asarray(j_pack_scalars(jnp.asarray(needles[q]), 777))
        )


@pytest.mark.parametrize("C,M", [(2048, 40), (256, 100)])
def test_row_gather_plain_equals_reference(C, M):
    """row_gather_plain against the reference's block_gather and
    row_gather at the capped (group rows) and broad (key blocks) shapes."""
    rng = np.random.default_rng(C + M)
    R = 64
    data = rng.integers(-(2**31), 2**31 - 1, (R, C), dtype=np.int64).astype(
        np.int32
    )
    rows = rng.integers(0, R, M).astype(np.int32)
    got = tcs.row_gather(torch.from_numpy(data), torch.from_numpy(rows))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jcs.row_gather(jnp.asarray(data), jnp.asarray(rows),
                                  interpret=True)),
    )
    if C % 1024 == 0:
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jcs.block_gather(jnp.asarray(data),
                                        jnp.asarray(rows), interpret=True)),
        )
    assert _build.LAUNCHES["row_gather"] == 0  # the CPU never launches


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    non-CUDA device raises instead of falling back."""
    meta = torch.empty((4, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcs.row_gather(meta, torch.zeros(2, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tcs.match_units_colstream(
            torch.empty((16, 8, 128), dtype=torch.int8, device="meta"),
            meta, meta, W=16, n=3, scoring=DEFAULT_SCORING,
        )
