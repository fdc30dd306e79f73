"""Pass 1 of the port's column-stream fuzzy match on its own
(``ops/colstream.colstream_window`` and ``colstream_window_units``, which
the plain version and chip_smoke.py's bound use) against frizbee_tpu's
Pallas kernel in interpret mode, and the launch geometry of the CUDA
colstream kernels (``ops/colstream.tile_geometry``).

The window helper's matched flag must equal the reference's matched
column, and its trimmed window wider than 1024 bytes the reference's
greedy column, for byte and codepoint rows at T = 0, 1, 3 and with no
prefilter; the window's unit count is held against a count made from the
row strings. Zero tolerance throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu.ops import kernels as jk
from frizbee_tpu_torch.config import Config, UnicodeMatching
from frizbee_tpu_torch.corpus import pack_corpus
from frizbee_tpu_torch.engine import make_engine
from frizbee_tpu_torch.ops import colstream as tcs
from frizbee_tpu_torch.ops import kernels as tk

SC = tk.DEFAULT_SCORING
GR = 1024
# shared memory a block may use on the H100 (227 KB)
SHARED_LIMIT = 232448
# (max_typos, no_prefilter): the greedy embedding, the minimal-position
# DP at its smallest and largest budget, no prefilter
BUDGETS = [(0, False), (1, False), (3, False), (0, True)]
ASCII_NOISE = list("abcdefABCDEF/_- xyz")
UNICODE_NOISE = list("abcXYZ/ _-éÉ€𐍈لЛл가다😀")
# rows whose trimmed windows straddle multi-byte units or exceed 1024
# bytes (greedy on a w512 bucket)
LONG_ROWS = [
    "€" * 120 + "linux" + "€" * 80,
    "a" * 199 + "لlinux",
    ("li" + "𐍈" * 50) * 2 + "nux",
    "l" + "€" * 400 + "inux",
    "L" + "😀" * 300 + "inux" + "€" * 30,
    "x" + "가" * 200 + "linux",
    "linux",
    "",
]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _needle(s, unicode):
    eng = make_engine(s, Config(unicode=UnicodeMatching.ALWAYS)
                      if unicode else Config())
    o, f, _sc = eng._host_needle()
    return np.concatenate([o, f])


def _rows(rng, count, width, needle, noise):
    """Strings of 0..width units; about a third carry the needle's units
    in order, now and then with one dropped or two swapped."""
    out = []
    for _ in range(count):
        n = int(rng.integers(0, width + 1)) if rng.random() < 0.6 \
            else int(rng.integers(0, 8))
        row = list(rng.choice(noise, n))
        if rng.random() < 0.35 and n >= len(needle):
            units = list(needle)
            if rng.random() < 0.3:
                del units[int(rng.integers(0, len(units)))]
            elif rng.random() < 0.3:
                units[0], units[-1] = units[-1], units[0]
            pos = np.sort(rng.choice(n, len(units), replace=False))
            for p, u in zip(pos, units):
                row[p] = u
        out.append("".join(row))
    return out + [needle, needle.upper()]


def _bucket(rows, width, unicode):
    """(row strings in the bucket's slot order, cpT, nuT, ctxT) of a
    one-bucket corpus; padding slots hold ''."""
    c = pack_corpus(rows, unicode=unicode, bucket_widths=(width,),
                    device="cpu")
    (b,) = c.buckets
    cpT, nuT, idxT, _blk, ctxT = b.device_arrays_colstream()
    by_slot = [rows[i] if i >= 0 else "" for i in idxT.tolist()]
    return by_slot, cpT, nuT, ctxT


def _reference(cpT, nuT, ctxT, needle, *, W, T, no_pre, unicode):
    n = len(needle) // 2
    return jcs.match_units_colstream(
        jnp.asarray(cpT.numpy()), jnp.asarray(nuT.numpy()),
        jk.pack_needle_scalars(jnp.asarray(needle), nuT.numel()), None,
        None, None if ctxT is None else jnp.asarray(ctxT.numpy()),
        W=W, n=n, max_typos=T, scoring=SC, no_prefilter=no_pre,
        unicode=unicode, interpret=True,
    )


def _window_units_from_strings(rows, wstart, wend, W):
    """Units of each row (its first W) whose UTF-8 bytes lie inside
    [wstart, wend)."""
    out = []
    for row, s, e in zip(rows, wstart, wend):
        off, count = 0, 0
        for ch in row[:W]:
            bl = len(ch.encode())
            count += off >= s and off + bl <= e
            off += bl
        out.append(count)
    return np.array(out)


def _check_window(rows, cpT, nuT, ctxT, needle, *, W, T, no_pre, unicode):
    n = len(needle) // 2
    want = _reference(cpT, nuT, ctxT, needle, W=W, T=T, no_pre=no_pre,
                      unicode=unicode)
    scal = tk.pack_needle_scalars(torch.from_numpy(needle[None, :]),
                                  nuT.numel())
    matched, wstart, wend, nb = tcs.colstream_window(
        cpT, nuT, scal, ctxT, W=W, n=n, max_typos=T, no_prefilter=no_pre)
    np.testing.assert_array_equal(matched[0].numpy().astype(np.int32),
                                  np.asarray(want[0]), err_msg="matched")
    greedy = matched & ((wend - wstart) > tk.MAX_HAYSTACK_LEN)
    np.testing.assert_array_equal(greedy[0].numpy().astype(np.int32),
                                  np.asarray(want[4]), err_msg="greedy")
    row_bytes = np.array([len(r[:W].encode()) for r in rows])
    np.testing.assert_array_equal(nb[0].numpy(), row_bytes)
    assert ((wstart >= 0) & (wstart <= wend) & (wend <= nb)).all()
    units = tcs.colstream_window_units(cpT, nuT, wstart, wend, ctxT, W=W)
    np.testing.assert_array_equal(
        units[0].numpy(),
        _window_units_from_strings(rows, wstart[0].tolist(),
                                   wend[0].tolist(), W))
    return matched, greedy


@pytest.mark.parametrize("T,no_pre", BUDGETS)
def test_window_bytes(T, no_pre):
    """Byte rows over two groups, a 5-byte needle: the window helper's
    verdict equals the reference's matched column; no byte window exceeds
    1024 bytes, as the reference's greedy column says."""
    rng = np.random.default_rng(40 + T)
    rows = _rows(rng, GR + 300, 48, "fAce/", ASCII_NOISE)
    by_slot, cpT, nuT, ctxT = _bucket(rows, 64, False)
    matched, _greedy = _check_window(by_slot, cpT, nuT, ctxT,
                                     _needle("fAce/", False), W=64, T=T,
                                     no_pre=no_pre, unicode=False)
    assert 0 < int(matched.sum()) < len(by_slot) or no_pre


@pytest.mark.parametrize("T,no_pre", BUDGETS)
def test_window_codepoints(T, no_pre):
    """Codepoint rows of 1- to 4-byte units with the ctx plane, and
    derived without it, against the reference."""
    rng = np.random.default_rng(50 + T)
    rows = _rows(rng, GR + 200, 60, "Линукс", UNICODE_NOISE)
    by_slot, cpT, nuT, ctxT = _bucket(rows, 64, True)
    nd = _needle("Линукс", True)
    for ctx in (ctxT, None):
        matched, _greedy = _check_window(by_slot, cpT, nuT, ctx, nd, W=64,
                                         T=T, no_pre=no_pre, unicode=True)
    assert 0 < int(matched.sum()) < len(by_slot) or no_pre


@pytest.mark.parametrize("T,no_pre", BUDGETS)
def test_window_greedy_codepoints(T, no_pre):
    """A w512 codepoint bucket whose windows straddle multi-byte units and
    exceed 1024 bytes: the helper's window > 1024 bytes equals the
    reference's greedy column."""
    by_slot, cpT, nuT, ctxT = _bucket(LONG_ROWS, 512, True)
    _matched, greedy = _check_window(by_slot, cpT, nuT, ctxT,
                                     _needle("linux", True), W=512, T=T,
                                     no_pre=no_pre, unicode=True)
    assert int(greedy.sum()) > 0


# rows a tile (the block's threads) per bucket width and shared-memory
# bytes a unit (a byte; a codepoint and its class byte): the most of 128,
# 64, 32 whose W columns fit 48 KB, else 32
TILE_ROWS = {
    1: {16: 128, 32: 128, 64: 128, 128: 128, 256: 128, 512: 64, 1024: 32},
    5: {16: 128, 32: 128, 64: 128, 128: 64, 256: 32, 512: 32, 1024: 32},
}


@pytest.mark.parametrize("unit_bytes", [1, 5])
@pytest.mark.parametrize("W", [16, 32, 64, 128, 256, 512, 1024])
def test_tile_geometry_rows_and_shared_memory(W, unit_bytes):
    """Every bucket width and unit size: the tile's rows, its shared
    memory (the staged columns, never above the H100's 227 KB a block),
    and a grid that covers every group's rows once per query chunk."""
    geo = tcs.tile_geometry(W, unit_bytes, 512, 32)
    assert geo["rows"] == TILE_ROWS[unit_bytes][W]
    assert geo["smem"] == geo["rows"] * W * unit_bytes
    assert geo["smem"] <= SHARED_LIMIT
    assert geo["smem"] <= tcs.TILE_BYTES or geo["rows"] == 32
    assert geo["tiles"] * geo["rows"] == 512 * GR
    # at most 512 query-columns a block
    qper = min(max(512 // W, 1), 32)
    assert (geo["qper"], geo["chunks"]) == (qper, -(-32 // qper))


@pytest.mark.parametrize("W,n_groups,Q,qper,chunks", [
    (64, 512, 32, 8, 4),    # a 1M-row bucket: 8 queries a block
    (16, 160, 32, 32, 1),   # 16-wide rows: all 32 queries in one block
    (16, 160, 33, 17, 2),   # ... at most 32: 17 and 16
    (32, 40, 17, 5, 4),     # 320 tiles: chunks of 5 (5, 5, 5, 2)
    (64, 7, 16, 1, 16),     # the Arabic corpus' w64 bucket: a query a block
    (64, 1, 32, 1, 32),     # one group: a query a block
    (1024, 3, 1, 1, 1),
])
def test_tile_geometry_query_chunks(W, n_groups, Q, qper, chunks):
    """A block serves at most 512 / W queries (1 to 32), and the queries
    split further until the launch has 1024 blocks; each chunk is a run
    of consecutive queries, every query in one."""
    geo = tcs.tile_geometry(W, 1, n_groups, Q)
    assert (geo["qper"], geo["chunks"]) == (qper, chunks)
    assert (chunks - 1) * qper < Q <= chunks * qper
    assert qper <= tcs.MAX_BLOCK_QUERIES
