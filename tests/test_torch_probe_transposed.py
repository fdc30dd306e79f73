"""The transposed-layout probe of the port (``frizbee_tpu_torch/probes/
transposed.py``: the plain version that the CUDA kernel
``csrc/probe_transposed.cu`` is held to on the card) against the reference
probes ``benchmarks/probe_transposed_check.py`` (``numpy_ref``, the scalar
NumPy recurrence) and ``benchmarks/probe_transposed.py``
(``make_transposed``, run as a ``pallas_call`` in interpret mode).

The reference scripts are imported by path; the check script imports the
timing script by module name, so the loaded timing script is registered
under that name first. Zero tolerance."""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu_torch.ops.kernels import pack_needle_scalars
from frizbee_tpu_torch.probes import transposed as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _load(name, as_name):
    path = os.path.join(ROOT, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(as_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def refs():
    timing = _load("probe_transposed", "probe_transposed")
    saved = sys.modules.get("probe_transposed")
    sys.modules["probe_transposed"] = timing
    try:
        check = _load("probe_transposed_check", "reference_transposed_check")
    finally:
        if saved is None:
            sys.modules.pop("probe_transposed", None)
        else:
            sys.modules["probe_transposed"] = saved
    return timing, check


def _scalars(needle, B):
    return tt.needle_scalars(needle, B, CPU)


def test_layout_matches_reference(refs):
    """The port's (B, W) -> unit-major block layout against the scripts'
    NumPy expression, at their SUBL."""
    timing, _check = refs
    assert timing.SUBL == tt.SUBL
    rng = np.random.default_rng(5)
    hay = rng.integers(97, 123, (2 * tt.BLOCK_ROWS, 24), dtype=np.int8)
    want = np.ascontiguousarray(
        hay.astype(np.int32).reshape(2, tt.SUBL, 128, 24)
        .transpose(0, 3, 1, 2)).reshape(-1, tt.SUBL, 128)
    np.testing.assert_array_equal(tt.to_blocks(torch.from_numpy(hay)).numpy(),
                                  want)


def test_check_inputs_draw_order():
    """The check's needle and rows come from seed 0 in the reference's
    order: the needle, the (8192, 64) rows, then the linearity timing's
    rows; the compare's the needle, then each shape's rows."""
    rng = np.random.default_rng(0)
    needle = rng.integers(97, 123, 8, dtype=np.int32)
    hay = rng.integers(97, 123, (8192, 64), dtype=np.int8)
    lin = rng.integers(97, 123, (4096, 16), dtype=np.int8)
    got = tt.check_inputs(CPU, lin_shape=(16, 4096))
    for g, w in zip(got, (needle, hay, lin)):
        np.testing.assert_array_equal(np.asarray(g), w)
    rng = np.random.default_rng(0)
    needle = rng.integers(97, 123, 8, dtype=np.int32)
    shapes = ((8, 4096), (16, 8192))
    for (W, B), (g_needle, g_hay) in zip(
            shapes, tt.compare_inputs(CPU, shapes=shapes)):
        np.testing.assert_array_equal(g_needle, needle)
        np.testing.assert_array_equal(
            g_hay.numpy(), rng.integers(97, 123, (B, W), dtype=np.int8))


def test_plain_best_against_numpy_ref(refs):
    """Per-row best of the plain version against the reference's scalar
    NumPy recurrence (``numpy_ref``) on 512 rows of the check's inputs."""
    _timing, check = refs
    needle, hay, _lin = tt.check_inputs(CPU, shape=(64, tt.BLOCK_ROWS),
                                        lin_shape=(8, tt.BLOCK_ROWS))
    got = tt.transposed_best_plain(tt.to_blocks(hay),
                                   _scalars(needle, tt.BLOCK_ROWS), W=64,
                                   n=tt.N)
    want = check.numpy_ref(hay.numpy()[:512], needle)
    np.testing.assert_array_equal(got.reshape(-1)[:512].numpy(), want)
    assert (want > 0).all()


@pytest.mark.parametrize("W", [24, 64])
def test_plain_sum_against_make_transposed(refs, W):
    """The sum of every row's best (int32, low 31 bits) against the
    reference's ``make_transposed`` kernel in interpret mode, at the probe's
    n = 8: two blocks of 4096 rows."""
    timing, _check = refs
    B = 2 * tt.BLOCK_ROWS
    rng = np.random.default_rng(W)
    needle = rng.integers(97, 123, tt.N, dtype=np.int32)
    hay = torch.from_numpy(rng.integers(97, 123, (B, W), dtype=np.int8))
    cpT = tt.to_blocks(hay)
    scal = _scalars(needle, B)
    run = timing.make_transposed(W, tt.N, B, interpret=True)
    want = int(run(jnp.asarray(cpT.numpy()), jnp.asarray(scal.numpy()),
                   jnp.int32(0)))
    got = tt.transposed_best(cpT, scal, W=W, n=tt.N)
    assert got.shape == (B // 128, 128) and got.dtype == torch.int32
    assert int(got.sum(dtype=torch.int64)) & 0x7FFFFFFF == want


def test_recurrence_takes_best_over_every_needle_unit():
    """The transposed recurrence takes its best over every needle unit's
    cell, not the last unit's alone (the bisect probe's stage_a does): a
    row holding only the needle's first unit scores 12."""
    needle = np.array([97, 98, 99, 100, 101, 102, 103, 104], np.int32)
    hay = np.full((tt.BLOCK_ROWS, 8), 120, np.int8)
    hay[0, 3] = 97
    got = tt.transposed_best_plain(
        tt.to_blocks(torch.from_numpy(hay)),
        _scalars(needle, tt.BLOCK_ROWS), W=8, n=tt.N).reshape(-1)
    assert int(got[0]) == 12 and int(got[1:].abs().sum()) == 0


def test_refuses_long_needles():
    hay = torch.zeros((tt.BLOCK_ROWS, 4), dtype=torch.int8)
    scal = _scalars(np.arange(97, 114, dtype=np.int32), tt.BLOCK_ROWS)
    with pytest.raises(ValueError, match="1-16"):
        tt.transposed_best(tt.to_blocks(hay), scal, W=4, n=17)


def test_probe_records_on_cpu(capsys):
    """The check and compare records at small shapes on the CPU: the
    reference's keys, ``correct`` true, times null."""
    assert tt.emit(tt.check(CPU, lin_shape=(8, tt.BLOCK_ROWS),
                            ks=(1, 2))) == 0
    assert tt.emit(tt.compare(CPU, shapes=((8, tt.BLOCK_ROWS),))) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"correct": True, "mismatches": 0}
    assert [x["K"] for x in lines[1:3]] == [1, 2]
    assert set(lines[3]) == {"W", "B", "n", "current_ms", "transposed_ms",
                             "speedup", "current_rows_per_s",
                             "transposed_rows_per_s"}
    assert lines[3]["current_ms"] is None


def test_int16_range_worst_case():
    """The kernel walks two rows in s16x2 halves and relies on every cell
    staying within 12 n. A one-unit needle repeated to n = 16 against rows
    of that unit at W = 1024 reaches exactly 12 n = 192 and never more;
    random rows over the same unit and one other never pass 12 n."""
    n, W = 16, 1024
    needle = np.full(n, 97, np.int32)
    hay = np.full((tt.BLOCK_ROWS, W), 97, np.int8)
    rng = np.random.default_rng(16)
    hay[1:] = rng.choice(np.array([97, 98], np.int8), (tt.BLOCK_ROWS - 1, W))
    best = tt.transposed_best_plain(
        tt.to_blocks(torch.from_numpy(hay)), _scalars(needle, tt.BLOCK_ROWS),
        W=W, n=n).reshape(-1)
    assert int(best[0]) == 12 * n
    assert int(best.max()) == 12 * n and int(best.min()) >= 0


def _source_constants(name):
    path = os.path.join(ROOT, "frizbee_tpu_torch", "csrc", name)
    with open(path) as fh:
        text = fh.read()
    return {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                        text)}


def test_ring_geometry_mirrors_source():
    """``ring_geometry``'s constants are the kernel source's."""
    src = _source_constants("probe_transposed.cu")
    assert int(src["kThreads"]) == tt.RING_THREADS
    assert src["kTileRows"].startswith("2 * kThreads")
    assert tt.RING_TILE_ROWS == 2 * tt.RING_THREADS
    assert int(src["kChunkCols"]) == tt.RING_CHUNK_COLS
    assert int(src["kRingStages"]) == tt.RING_STAGES
    assert int(src["kMinBlocks"]) == tt.RING_MIN_BLOCKS
    ring = _source_constants("column_ring.cuh")
    assert int(ring["kNoUnit"]) + 1 == tt.TABLE_UNITS
    assert [tt.hit_words(n) for n in range(1, 17)] == [1] * 4 + [2] * 4 + [4] * 8


@pytest.mark.parametrize("W, B", [tt.CHECK_SHAPE, tt.LINEARITY_SHAPE,
                                  *tt.COMPARE_SHAPES, (24, 4096)])
def test_ring_geometry(W, B):
    """At the check, linearity, compare and edge shapes: every row is
    walked by exactly one thread half, a block's shared memory fits the
    card's 227 KB at every n, and the linearity check's 131,072 rows fill
    the 132 SMs."""
    n_blocks = B // tt.BLOCK_ROWS
    geo = tt.ring_geometry(n_blocks, W, tt.N)
    rows = tt.ring_rows(geo["blocks"])
    assert rows.shape[1] == geo["threads"]
    assert np.array_equal(np.sort(rows.reshape(-1)), np.arange(B))
    assert geo["chunks"] * geo["chunk_cols"] >= W > (
        geo["chunks"] - 1) * geo["chunk_cols"]
    for n in range(1, 17):
        assert tt.ring_geometry(n_blocks, W, n)["smem"] <= 227 * 1024
    if B == tt.LINEARITY_SHAPE[1]:
        assert geo["blocks"] >= 132


BIAS = 64  # csrc/column_ring.cuh kBias: each 16-bit half holds a value + 64


def _ring_cells(hay, needle):
    """The kernel's cells in a vectorised numpy model: each unit's needle
    operand from its table entry (its diagonal operand + 6: 18 on a hit, 0
    else), then, each value + BIAS, cur = max(diag_in + d - 6, prev - 1,
    BIAS), best over every cell; every value the walk forms stays inside
    an unsigned 16-bit half. Returns each row's best."""
    B, W = hay.shape
    n = len(needle)
    table = np.where(np.arange(257)[:, None] == needle[None, :], 18, 0)
    idx = np.where((hay >= 0) & (hay < 256), hay, 256)
    d = table[idx]  # (B, W, n)
    outside = (idx == 256) & np.isin(hay, needle)
    d[outside] = np.where(hay[outside][:, None] == needle[None, :], 18, 0)
    prev = np.full((B, n), BIAS, np.int64)
    best = np.full(B, BIAS, np.int64)
    for j in range(W):
        diag_in = np.concatenate([np.full((B, 1), BIAS, np.int64),
                                  prev[:, :-1]], 1)
        diag = diag_in + d[:, j] - 6
        assert diag.min() >= 0 and (prev - 1).min() >= 0
        prev = np.maximum(np.maximum(diag, prev - 1), BIAS)
        assert prev.max() <= 12 * n + BIAS < 1 << 16
        best = np.maximum(best, prev.max(1))
    return best - BIAS


@pytest.mark.parametrize("n, lo, hi", [(8, 97, 103), (16, 97, 99),
                                       (3, -300, 400)])
def test_ring_cell_model(n, lo, hi):
    """The kernel's rewritten cell (a table operand, two packed adds and a
    3-input max, no compare) against the plain version, units inside and outside the
    table's [0, 256), a needle unit outside it in the last case."""
    rng = np.random.default_rng(n)
    W = 20
    hay = rng.integers(lo, hi, (tt.BLOCK_ROWS, W)).astype(np.int32)
    needle = rng.integers(97, 100, n).astype(np.int32)
    if lo < 0:
        needle[0] = 300
        hay[:32] = 300
    scal = pack_needle_scalars(
        torch.from_numpy(np.concatenate([needle, needle])), tt.BLOCK_ROWS)
    want = tt.transposed_best_plain(tt.to_blocks(torch.from_numpy(hay)),
                                    scal, W=W, n=n).reshape(-1).numpy()
    np.testing.assert_array_equal(_ring_cells(hay, needle), want)
