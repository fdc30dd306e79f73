"""Probe: the transposed (column-stream) layout's affine recurrence, checked
against its plain version and timed against the row-major kernel, on the
card.

    python -m frizbee_tpu_torch.probes.transposed [--mode check|compare]
        [--device cpu]

Counterpart of ``benchmarks/probe_transposed_check.py`` (``kernel_raw``,
``pallas_call`` :96, checked against ``numpy_ref`` :20) and
``benchmarks/probe_transposed.py`` (``make_transposed`` :60, ``pallas_call``
:95). Both run one recurrence, a Smith-Waterman stripped of prefilter,
window and bonus: per row, for each unit column and needle unit k,
``diag = occ ? diag_in + 12 : max(diag_in - 6, 0)``, ``cur = max(diag,
max(prev[k] - 1, 0))``, ``best = max(best, cur)``, ``diag_in = prev[k]``
(0 at k = 0), ``prev[k] = cur``; each row's best is the output. The
reference's row maximum (``srow``/``left``) never reaches the output and
is not computed. :func:`transposed_best` runs it as the CUDA kernel
``csrc/probe_transposed.cu`` on a CUDA tensor (a block streams the unit
columns of 512 rows through a shared-memory ring, a thread walks two rows
in s16x2 halves; :func:`ring_geometry` mirrors its launch) and as
:func:`transposed_best_plain` on a CPU tensor.

Layout: the reference's unit-major blocks, (nB * W, 32, 128) int32, unit j
of row i of block b at [b * W + j, i // 128, i % 128]; the kernel reads it
with no copy as (nB, W, 4096).

``check`` (the reference's check script): at B = 8192, W = 64, n = 8 the
kernel against its plain version (``correct``, ``mismatches``); then, at
W = 128, B = 131072, K back-to-back launches for K in 4, 16, 64
(``total_ms``, ``per_iter_ms``), which must stay flat in K.
``compare`` (the reference's timing script): at (W, B) = (64, 262144),
(128, 131072) and (128, 1048576), the row-major ``match_units`` (int32,
no prefilter, typo budget 0, columns mode, every row W units long)
against the transposed kernel: ``current_ms``, ``transposed_ms``,
``speedup`` and rows per second of each. Inputs are the reference's:
seed 0, an 8-byte needle and rows of bytes in [97, 123), in its draw
order. Times are CUDA-event medians; on the CPU they print as null.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.kernels import DEFAULT_SCORING, match_units, pack_needle_scalars
from . import emit, median_ms, resolve_device

SUBL = 32
BLOCK_ROWS = SUBL * 128
MAX_N = 16
N = 8
CHECK_SHAPE = (64, 2 * BLOCK_ROWS)  # (W, B)
LINEARITY_SHAPE = (128, 131072)
LINEARITY_K = (4, 16, 64)
COMPARE_SHAPES = ((64, 262144), (128, 131072), (128, 1048576))

# the kernel's launch geometry (csrc/probe_transposed.cu kThreads,
# kTileRows, kChunkCols, kRingStages, kMinBlocks; csrc/column_ring.cuh
# kTableUnits and HitWords)
RING_THREADS = 256
RING_TILE_ROWS = 2 * RING_THREADS
RING_CHUNK_COLS = 8
RING_STAGES = 4
RING_MIN_BLOCKS = 3
TABLE_UNITS = 257


def hit_words(n: int) -> int:
    """32-bit words of a unit's entry in the kernels' needle-hit table: a
    byte a needle unit, 1, 2 or 4 words."""
    return 1 if n <= 4 else 2 if n <= 8 else 4


def ring_rows(tiles: int, tile_rows: int = RING_TILE_ROWS,
              threads: int = RING_THREADS) -> np.ndarray:
    """(tiles, threads, 2) int64: the two rows that each thread of each
    block walks, as the kernels compute them: block t takes tile t, rows t
    * tile_rows .. of the launch, and its thread i rows 2i and 2i + 1 of
    it."""
    t = np.arange(tiles, dtype=np.int64)[:, None, None]
    return (t * tile_rows + 2 * np.arange(threads)[None, :, None]
            + np.arange(2))


def ring_geometry(n_blocks: int, W: int, n: int) -> dict:
    """The kernel's launch for cpT of ``n_blocks`` layout blocks of W
    columns and an n-unit needle: ``blocks`` of ``threads`` threads, each a
    tile of ``tile_rows`` rows (8 a layout block); a tile's ``chunks`` of
    ``chunk_cols`` columns through a ring of ``stages`` slots; ``smem``
    the bytes of shared memory a block takes (the ring and the needle-hit
    table, dynamic, and the needle, static)."""
    _check_n(n)
    ring = RING_STAGES * RING_CHUNK_COLS * RING_TILE_ROWS * 4
    return {"blocks": n_blocks * (BLOCK_ROWS // RING_TILE_ROWS),
            "threads": RING_THREADS, "tile_rows": RING_TILE_ROWS,
            "chunk_cols": RING_CHUNK_COLS, "stages": RING_STAGES,
            "chunks": -(-W // RING_CHUNK_COLS),
            "smem": ring + TABLE_UNITS * hit_words(n) * 4 + 4 * n}


def to_blocks(hay: torch.Tensor) -> torch.Tensor:
    """(B, W) units -> the reference's (B / 4096 * W, 32, 128) int32
    unit-major blocks, B a multiple of 4096."""
    B, W = hay.shape
    return (hay.to(torch.int32).reshape(B // BLOCK_ROWS, SUBL, 128, W)
            .permute(0, 3, 1, 2).reshape(-1, SUBL, 128).contiguous())


def _check_n(n: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the transposed kernel holds needles of 1-{MAX_N} "
                         f"units, not {n}")


def transposed_best_plain(cpT, scal, *, W: int, n: int) -> torch.Tensor:
    """Plain version of :func:`transposed_best`: the recurrence over all
    rows at once, a column and a needle unit at a time."""
    _check_n(n)
    nB = cpT.shape[0] // W
    cols = cpT.reshape(nB, W, BLOCK_ROWS)
    needle = scal[2:2 + n].tolist()
    zero = torch.zeros((nB, BLOCK_ROWS), dtype=torch.int32,
                       device=cpT.device)
    prev = [zero] * n
    best = zero
    for j in range(W):
        hay = cols[:, j]
        diag_in = zero
        for k in range(n):
            diag = torch.where(hay == needle[k], diag_in + 12,
                               torch.clamp(diag_in - 6, min=0))
            cur = torch.maximum(diag, torch.clamp(prev[k] - 1, min=0))
            best = torch.maximum(best, cur)
            diag_in = prev[k]
            prev[k] = cur
    return best.reshape(nB * SUBL, 128)


def transposed_best(cpT, scal, *, W: int, n: int) -> torch.Tensor:
    """Each row's best cell of the transposed recurrence: cpT (nB * W, 32,
    128) int32 unit-major blocks, scal (130,) int32 needle scalars
    (:func:`ops.kernels.pack_needle_scalars`; the needle is scal[2:2+n]),
    1 <= n <= 16. Returns (nB * 32, 128) int32. The CUDA kernel on a CUDA
    tensor (counted in ``_build.LAUNCHES["probe_transposed"]``), the plain
    version on a CPU tensor."""
    if cpT.device.type == "cpu":
        return transposed_best_plain(cpT, scal, W=W, n=n)
    if cpT.device.type != "cuda":
        raise ValueError(f"unsupported device {cpT.device}")
    _check_n(n)
    if W < 1 or cpT.shape[0] % W:
        raise ValueError(f"cpT rows {cpT.shape[0]} are no multiple of W={W}")
    nB = cpT.shape[0] // W
    _build.check_operands(cpT.device, (
        ("cpT", cpT, torch.int32, (nB * W, SUBL, 128)),
        ("scal", scal, torch.int32, (2 + 2 * 64,)),
    ))
    out = torch.empty((nB * SUBL, 128), dtype=torch.int32, device=cpT.device)
    _build.launch("probe_transposed", cpT.device, _build.ptr(cpT),
                  _build.ptr(scal), _build.ptr(out), nB, W, n,
                  _build.stream(cpT), call=((cpT, scal), dict(W=W, n=n)))
    return out


def _needle(rng):
    return rng.integers(97, 123, N, dtype=np.int32)


def needle_scalars(needle, count, device):
    """The (130,) int32 scalars of an 8-unit needle, orig and flip halves
    both the needle, as the reference packs them."""
    packed = torch.from_numpy(np.concatenate([needle, needle]))
    return pack_needle_scalars(packed, count).to(device)


def _hay(rng, B, W, device):
    return torch.from_numpy(
        rng.integers(97, 123, (B, W), dtype=np.int8)).to(device)


def check_inputs(device, *, shape=CHECK_SHAPE, lin_shape=LINEARITY_SHAPE,
                 seed=0):
    """(needle, rows of the check, rows of the linearity timing): the
    reference's needle and (B, W) int8 rows at ``shape`` and
    ``lin_shape``, drawn in its order."""
    rng = np.random.default_rng(seed)
    needle = _needle(rng)
    (W, B), (lW, lB) = shape, lin_shape
    return needle, _hay(rng, B, W, device), _hay(rng, lB, lW, device)


def check(device, *, shape=CHECK_SHAPE, lin_shape=LINEARITY_SHAPE,
          ks=LINEARITY_K, reps=5, seed=0):
    """Yield the check script's records: ``correct``/``mismatches`` of the
    kernel against its plain version, then ``K``, ``total_ms`` and
    ``per_iter_ms`` for K back-to-back launches."""
    needle, hay, lin_hay = check_inputs(device, shape=shape,
                                        lin_shape=lin_shape, seed=seed)
    W, B = shape
    cpT = to_blocks(hay)
    scal = needle_scalars(needle, B, device)
    got = transposed_best(cpT, scal, W=W, n=N)
    want = transposed_best_plain(cpT, scal, W=W, n=N)
    bad = int((got != want).sum())
    yield {"correct": bad == 0, "mismatches": bad}
    W, B = lin_shape
    cpT = to_blocks(lin_hay)
    scal = needle_scalars(needle, B, device)
    for K in ks:
        t = median_ms(lambda: [transposed_best(cpT, scal, W=W, n=N)
                               for _ in range(K)], device, reps)
        yield {"K": K, "total_ms": t,
               "per_iter_ms": None if t is None else t / K}


def compare_inputs(device, *, shapes=COMPARE_SHAPES, seed=0):
    """Yield (needle, rows) per (W, B) of ``shapes``: the reference's
    needle and (B, W) int8 rows, drawn in its order."""
    rng = np.random.default_rng(seed)
    needle = _needle(rng)
    for W, B in shapes:
        yield needle, _hay(rng, B, W, device)


def compare(device, *, shapes=COMPARE_SHAPES, reps=5, seed=0):
    """Yield the timing script's records: the row-major kernel (the port's
    ``match_units``) against the transposed kernel at each (W, B)."""
    for needle, hay in compare_inputs(device, shapes=shapes, seed=seed):
        B, W = hay.shape
        nu = torch.full((B,), W, dtype=torch.int32, device=device)
        scal = needle_scalars(needle, B, device)
        cur = median_ms(lambda: match_units(
            hay, nu, scal[None], n=N, max_typos=0, scoring=DEFAULT_SCORING,
            no_prefilter=True), device, reps)
        cpT = to_blocks(hay)
        tr = median_ms(lambda: transposed_best(cpT, scal, W=W, n=N), device,
                       reps)
        del cpT
        timed = cur is not None and tr is not None
        yield {"W": W, "B": B, "n": N, "current_ms": cur,
               "transposed_ms": tr,
               "speedup": cur / tr if timed else None,
               "current_rows_per_s": B / cur * 1e3 if timed else None,
               "transposed_rows_per_s": B / tr * 1e3 if timed else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("check", "compare", "both"),
                    default="both")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    rc = 0
    if a.mode in ("check", "both"):
        rc = emit(check(device))
    if rc == 0 and a.mode in ("compare", "both"):
        rc = emit(compare(device))
    return rc


if __name__ == "__main__":
    sys.exit(main())
