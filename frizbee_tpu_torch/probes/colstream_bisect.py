"""Probe: the column-stream fuzzy kernel built up stage by stage, each stage
a CUDA kernel held bit-equal to its plain version, then the whole kernel.

    python -m frizbee_tpu_torch.probes.colstream_bisect [--rows 1048576]
        [--device cpu]

Counterpart of ``benchmarks/probe_colstream_bisect.py`` (``run`` :41,
``pallas_call`` :42; ``stage_a`` :63, ``stage_b`` :88, ``stage_c`` :173,
``stage_c1`` :236, ``stage_c2`` :272, then the whole
``match_units_colstream`` :222) and ``benchmarks/probe_colstream_bisect2.py``
(``run`` :35, ``pallas_call`` :36; ``make_stage(track_fstart, track_tail,
out_carries)`` :57 in five combinations). There each stage bisected a TPU
compiler crash; here each is a template instantiation of
``csrc/probe_colstream_bisect.cu`` that computes exactly what the
reference's stage computes (a block streams the unit columns of 512 rows
through a shared-memory ring, a thread walks two rows, each unit's needle
hits one lookup of a table the block writes; :func:`ring_geometry`
mirrors the launch), and the stages split the
colstream kernel's cost: the SW pass alone (b), the prefilter pass alone
(c), its advance chain alone (c2), and the window tracking (bisect2).

Inputs are the reference's module-level arrays, rebuilt with numpy: seed
0, ``cp`` (2048, 64) units in [97, 103), ``nu`` in [0, 64], an 8-unit
needle and its upper case (needle - 32) as the flip half, in the
colstream layout: ``cpT`` (nG * 64, 8, 128) int32, unit j of row i of
group g at [g * 64 + j, i // 128, i % 128], and ``nuT`` (nG * 8, 128).
Every stage writes five (nG * 8, 128) int32 planes, the reference's.

Prints ``{"stage", "ok"}`` per stage in the reference scripts' order
(``a_simple+outs``, ``b_full_sw``, ``c_pf_t0``, ``full``,
``c1_no_advance``, ``c2_only_advance``, then bisect2's five); ``ok`` is
the kernel bit-equal to its plain version (``full``: the port's
``match_units_colstream`` kernel against its plain version, byte units,
the reference's scoring), and a false one ends the run with exit code 1.
``--rows R`` then runs every stage again at R rows (R / 1024 groups; the
1M-row fuzzy shape is 1048576) and adds ``rows`` and ``ms`` (CUDA-event
median) to each line: at 2048 rows a stage times only its launch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.colstream import (
    match_units_colstream,
    match_units_colstream_plain,
)
from ..ops.kernels import (
    MAX_KERNEL_NEEDLE,
    is_delim,
    is_lower,
    is_upper,
    pack_needle_scalars,
)
from . import emit, median_ms, resolve_device
from .transposed import TABLE_UNITS, hit_words

SUBL = 8
GROUP_ROWS = SUBL * 128
W, N = 64, 8
GROUPS = 2
MAX_N = 16
FULL_SCORING = (12, 6, 5, 1, 12, 4, 4, 8, 4)

# the C entry point's stage ids are the indices of STAGES
STAGES = (
    "a_simple+outs", "b_full_sw", "c_pf_t0", "c1_no_advance",
    "c2_only_advance", "fstart_only_outz", "tail_only_outz", "both_outz",
    "none_outcarries", "both_outcarries",
)
# the prefilter stages: (advance, track the first hit's start, track the
# tail's end, write the carries in planes 2-4). The advance is the chain
# (np == k) & occ_k, any hit of the column, or the first unit's hit.
PF_STAGES = {
    "c_pf_t0": ("chain", True, True, True),
    "c1_no_advance": ("any", True, True, True),
    "c2_only_advance": ("chain", False, False, False),
    "fstart_only_outz": ("hit0", True, False, False),
    "tail_only_outz": ("hit0", False, True, False),
    "both_outz": ("hit0", True, True, False),
    "none_outcarries": ("hit0", False, False, True),
    "both_outcarries": ("hit0", True, True, True),
}
# the kernel's launch geometry (csrc/probe_colstream_bisect.cu kThreads,
# kTileRows, kChunkCols, kRingStages, kMinBlocks and the stages' tables:
# stage A a hit
# word set a unit, stage B one for each of 4 bonus classes and one of gap
# costs plus 272 bytes of byte classes and 80 of bonus classes, the
# prefilter stages a 32-bit hit mask a unit)
RING_THREADS = 256
RING_TILE_ROWS = 2 * RING_THREADS
RING_CHUNK_COLS = 8  # stages A and B
RING_MIN_BLOCKS = 3
RING_PREFILTER_CHUNK_COLS = 16  # the prefilter stages
RING_PREFILTER_MIN_BLOCKS = 2
RING_STAGES = 3
BONUS_CLASSES = 4
CLASS_BYTES, CLASS_PAIR_BYTES = 272, 80
# what the reference scripts print, in order ("full": the whole kernel)
REFERENCE_ORDER = (
    "a_simple+outs", "b_full_sw", "c_pf_t0", "full", "c1_no_advance",
    "c2_only_advance", "fstart_only_outz", "tail_only_outz", "both_outz",
    "none_outcarries", "both_outcarries",
)


def bisect_inputs(groups: int = GROUPS, seed: int = 0):
    """The reference's (cp (B, W) int32, nu (B,) int32, needle (N,) int32)
    at B = groups * 1024 rows, drawn in its order."""
    rng = np.random.default_rng(seed)
    B = groups * GROUP_ROWS
    cp = rng.integers(97, 103, (B, W)).astype(np.int32)
    nu = rng.integers(0, W + 1, B).astype(np.int32)
    needle = rng.integers(97, 103, N).astype(np.int32)
    return cp, nu, needle


def to_colstream(cp, nu, needle, device):
    """(cpT (nG * W, 8, 128) int32, nuT (nG * 8, 128) int32, scal (130,)
    int32) on ``device``: the reference's colstream layout and needle
    scalars (orig = needle, flip = needle - 32, count = B)."""
    B, w = cp.shape
    cp_t = torch.from_numpy(cp).to(device)
    cpT = (cp_t.reshape(B // GROUP_ROWS, SUBL, 128, w).permute(0, 3, 1, 2)
           .reshape(-1, SUBL, 128).contiguous())
    nuT = torch.from_numpy(nu).to(device).reshape(-1, 128)
    scal = pack_needle_scalars(
        torch.from_numpy(np.concatenate([needle, needle - 32])), B)
    return cpT, nuT, scal.to(device)


def _stage_a(cols, nuv, orig, n):
    z = torch.zeros_like(nuv)
    h = [z] * n
    best = z
    for j in range(cols.shape[0]):
        hay = cols[j]
        valid = nuv > j
        diag_in = z
        for k in range(n):
            occ = valid & (hay == orig[k])
            diag = torch.where(occ, diag_in + 12,
                               torch.clamp(diag_in - 6, min=0))
            cur = torch.maximum(diag, torch.clamp(h[k] - 1, min=0))
            diag_in = h[k]
            h[k] = cur
        best = torch.maximum(best, h[n - 1])
    return [best + i for i in range(5)]


def _stage_b(cols, nuv, sc, orig, flip, n):
    Wc = cols.shape[0]
    z = torch.zeros_like(nuv)
    wstart = z
    wend = torch.clamp(nuv, max=Wc)
    nb = wend
    include_exact = (wstart == 0) & (wend == nb)
    include_prefix = wstart == 0
    h = [z] * n
    mm_bits = boff = seen_first = best = end_b = neq = z
    prev_last = torch.full_like(nuv, -1)
    for j in range(Wc):
        hay = cols[j]
        valid = nuv > j
        first = torch.where(valid, hay, 0)
        last = first
        blen = valid.int()
        active = valid & (boff >= wstart) & (boff + blen <= wend)
        is_first = active & (seen_first == 0)
        seen_first = seen_first | active.int()
        pb = torch.where(valid, prev_last, -1)
        cap_mask = is_upper(first) & is_lower(pb) & ~is_first
        delim_mask = is_delim(pb) & ~is_delim(first) & ~is_first
        bonus = (cap_mask.int() * 4 + delim_mask.int() * 4
                 + (is_first & include_prefix).int() * 12)
        diag_in = up_src = mm_new = z
        mm_prev = torch.zeros_like(valid)
        for k in range(n):
            occ = active & ((hay == orig[k]) | (hay == flip[k]))
            exactc = active & (hay == orig[k])
            diag = torch.where(occ, diag_in + 12 + bonus + exactc.int() * 4,
                               torch.clamp(diag_in - 6, min=0))
            up = torch.clamp(up_src - 1 - mm_prev.int() * 4, min=0)
            # the left move is not clamped
            left = h[k] - 1 - ((mm_bits >> k) & 1) * 4
            cur = torch.maximum(torch.maximum(diag, up), left)
            diag_in = h[k]
            up_src = cur
            mm_prev = occ
            h[k] = cur
            mm_new = mm_new | (occ.int() << k)
            if k == n - 1:
                masked = torch.where(active, cur, 0)
                end_b = torch.where(masked > best, boff, end_b)
                best = torch.maximum(best, masked)
        if j < n:  # scal[2 + min(j, 63)], gated by j < n
            neq = neq | (hay != sc[2 + min(j, 63)]).int()
        mm_bits = mm_new
        boff = boff + blen
        prev_last = last
    score = torch.clamp(best, min=0)
    exact = include_exact & (nuv == n) & (neq == 0)
    return [torch.ones_like(nuv), score, exact.int(),
            torch.where(score > 0, end_b, wstart), z]


def _stage_pf(cols, nuv, orig, flip, n, advance, fstart_on, tail_on,
              carries):
    z = torch.zeros_like(nuv)
    np_ = nb = boff = fstart = ffound = e_u = e_found = z
    for j in range(cols.shape[0]):
        hay = cols[j]
        valid = nuv > j
        blen = valid.int()
        adv = torch.zeros_like(valid)
        for k in range(n):
            occ_k = valid & ((hay == orig[k]) | (hay == flip[k]))
            if advance == "chain":
                adv = adv | ((np_ == k) & occ_k)
            elif advance == "any":
                adv = adv | occ_k
            if k == 0:
                hit0 = occ_k
            if k == n - 1:
                occ_last = occ_k
        if advance == "hit0":
            adv = hit0
        if fstart_on:
            fstart = torch.where((ffound > 0) | ~hit0, fstart, boff)
            ffound = ffound | hit0.int()
        np2 = np_ + adv.int()
        if tail_on:
            tail = occ_last & (np2 >= n)
            e_u = torch.where(tail, boff + blen, e_u)
            e_found = e_found | tail.int()
        np_, nb, boff = np2, nb + blen, boff + blen
    if carries:
        return [(np_ >= n).int(), nb, fstart, e_u, e_found]
    return [(np_ >= n).int(), nb, z, z, z]


def _check_args(stage, n):
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the bisect kernel holds needles of 1-{MAX_N} "
                         f"units, not {n}")


def ring_geometry(nG: int, W: int, n: int, stage: str) -> dict:
    """The kernel's launch for ``nG`` groups of W columns, an n-unit
    needle and ``stage`` (chunks of 8 columns for stages A and B, 16 for
    the prefilter stages): ``blocks`` of ``threads`` threads, each a tile of
    ``tile_rows`` rows (2 a group; tile t holds rows t * tile_rows .. of
    the launch, ``transposed.ring_rows``); a tile's ``chunks`` of
    ``chunk_cols`` columns through a ring of ``stages`` slots; ``smem``
    the bytes of shared memory a block takes (the ring and the stage's
    tables, dynamic, and the needle's two halves, static)."""
    _check_args(stage, n)
    cols = (RING_CHUNK_COLS if stage in ("a_simple+outs", "b_full_sw")
            else RING_PREFILTER_CHUNK_COLS)
    ring = RING_STAGES * cols * RING_TILE_ROWS * 4
    words = TABLE_UNITS * hit_words(n) * 4
    tables = {"a_simple+outs": words,
              "b_full_sw": ((BONUS_CLASSES + 1) * words + CLASS_BYTES
                            + CLASS_PAIR_BYTES)}.get(stage, TABLE_UNITS * 4)
    return {"blocks": nG * (GROUP_ROWS // RING_TILE_ROWS),
            "threads": RING_THREADS, "tile_rows": RING_TILE_ROWS,
            "chunk_cols": cols, "stages": RING_STAGES,
            "chunks": -(-W // cols), "smem": ring + tables + 8 * n}


def bisect_stage_plain(stage, cpT, nuT, scal, *, W: int, n: int):
    """Plain version of :func:`bisect_stage`: the reference stage's
    arithmetic over all rows at once, a column and a needle unit at a
    time."""
    _check_args(stage, n)
    nG = cpT.shape[0] // W
    # (W, rows): column j of every row, rows in group order
    cols = cpT.reshape(nG, W, GROUP_ROWS).transpose(0, 1).reshape(W, -1)
    nuv = nuT.reshape(-1)
    sc = scal.tolist()
    orig = sc[2:2 + n]
    flip = sc[2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n]
    if stage == "a_simple+outs":
        planes = _stage_a(cols, nuv, orig, n)
    elif stage == "b_full_sw":
        planes = _stage_b(cols, nuv, sc, orig, flip, n)
    else:
        planes = _stage_pf(cols, nuv, orig, flip, n, *PF_STAGES[stage])
    return torch.stack(planes).to(torch.int32).reshape(5, nG * SUBL, 128)


def bisect_stage(stage, cpT, nuT, scal, *, W: int, n: int):
    """The five (nG * 8, 128) int32 planes, stacked as (5, nG * 8, 128),
    that the reference's ``stage`` (a name of ``STAGES``) writes for cpT
    (nG * W, 8, 128) int32 units, nuT (nG * 8, 128) int32 unit counts and
    scal (130,) int32 needle scalars, 1 <= n <= 16. The CUDA kernel on a
    CUDA tensor (counted in ``_build.LAUNCHES["probe_colstream_bisect"]``),
    the plain version on a CPU tensor."""
    if cpT.device.type == "cpu":
        return bisect_stage_plain(stage, cpT, nuT, scal, W=W, n=n)
    if cpT.device.type != "cuda":
        raise ValueError(f"unsupported device {cpT.device}")
    _check_args(stage, n)
    if W < 1 or cpT.shape[0] % W:
        raise ValueError(f"cpT rows {cpT.shape[0]} are no multiple of W={W}")
    nG = cpT.shape[0] // W
    _build.check_operands(cpT.device, (
        ("cpT", cpT, torch.int32, (nG * W, SUBL, 128)),
        ("nuT", nuT, torch.int32, (nG * SUBL, 128)),
        ("scal", scal, torch.int32, (2 + 2 * MAX_KERNEL_NEEDLE,)),
    ))
    out = torch.empty((5, nG * SUBL, 128), dtype=torch.int32,
                      device=cpT.device)
    _build.launch("probe_colstream_bisect", cpT.device, _build.ptr(cpT),
                  _build.ptr(nuT), _build.ptr(scal), _build.ptr(out), nG, W,
                  n, STAGES.index(stage), _build.stream(cpT),
                  call=((stage, cpT, nuT, scal), dict(W=W, n=n)))
    return out


def full_args(cpT, nuT, scal):
    """The whole kernel's call on the bisect inputs, as the reference's
    ``main`` makes it (byte units, typo budget 0, the prefilter on): the
    port's ``match_units_colstream`` positional and keyword arguments."""
    return ((cpT.to(torch.int8), nuT, scal[None]),
            dict(W=W, n=N, max_typos=0, scoring=FULL_SCORING,
                 no_prefilter=False))


def run(device, *, groups=GROUPS, timed=False, reps=5, seed=0):
    """Yield ``{"stage", "ok"}`` per stage in ``REFERENCE_ORDER`` at
    ``groups`` colstream groups of the reference's inputs; ``timed`` adds
    ``rows`` and ``ms``."""
    cpT, nuT, scal = to_colstream(*bisect_inputs(groups, seed), device)
    for stage in REFERENCE_ORDER:
        if stage == "full":
            a, kw = full_args(cpT, nuT, scal)

            def fn():
                return match_units_colstream(*a, **kw)
            want = match_units_colstream_plain(*a, **kw)
            ok = all(torch.equal(g, w) for g, w in zip(fn(), want))
        else:
            def fn(stage=stage):
                return bisect_stage(stage, cpT, nuT, scal, W=W, n=N)
            ok = torch.equal(fn(), bisect_stage_plain(stage, cpT, nuT, scal,
                                                      W=W, n=N))
        rec = {"stage": stage, "ok": bool(ok)}
        if timed:
            rec.update(rows=groups * GROUP_ROWS,
                       ms=median_ms(fn, device, reps))
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=0,
                    help="also time every stage at this many rows (a "
                         "multiple of 1024)")
    a = ap.parse_args(argv)
    if a.rows % GROUP_ROWS:
        ap.error(f"--rows must be a multiple of {GROUP_ROWS}")
    device = resolve_device(a.device)
    rc = emit(run(device))
    if rc == 0 and a.rows:
        rc = emit(run(device, groups=a.rows // GROUP_ROWS, timed=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())
