"""Smoke run of frizbee_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``frizbee_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), then:

1. kernel phase: each kernel against its plain PyTorch version on the
   card, bit-equal, at the shapes of the 1M-row corpus — the column-stream
   fuzzy kernel on every bucket (w64, w128, w256) for the Q=32 serving
   queries with T=0, T=1 and no prefilter, flags on and off, key-emit on
   and off; the column-stream literal kernel on every bucket in all four
   modes, flags and key-emit on and off, at Q=32; the row-major kernel on
   every bucket at (n=8, T=4), (n=24, T=0) and (n=24, no prefilter), all
   rows in five-column mode and a live count below B through a random
   row order in key-emit mode, and at every template boundary (needle
   lengths 8-64 x typo budgets 0-8, byte and codepoint rows, both modes)
   on a bucket with all-matched, all-rejected and mixed blocks; both
   column-stream kernels at their tile boundaries (every bucket width
   16-1024, Q = 1, 2, 17, 33, blocks that share a tile among queries,
   groups alive for one query or none, live counts ending mid-group,
   rows of 0 and W units, byte and codepoint rows, all four literal modes
   at n = 1, 2 and 16, both output modes); the int16-lane instantiations
   of both DP kernels against their int16 plain versions at the same
   serving shapes, at every row-major template boundary and colstream
   tile boundary, and at the pairing boundaries (live counts 1, 2, 31,
   33 and odd, rows of 0 and W units paired, one half matched and the
   other rejected); the lane contract kernel against its plain model; the
   row gather at 128-, 256-, 384- and 2048-word rows, 1, 7 and the capped
   finalize's or broad tournament's rows; and the unicode variant of each
   match kernel
   on every bucket of a 1M-row Arabic codepoint corpus at Q=16 (the
   colstream kernels with the ctx plane, the plain versions on a subset
   of groups; the row-major kernel at (n=8, T=4) through a row order and
   at (n=20, T=0)), and on a w512 block whose windows exceed 1024 bytes;
2. serving phase, five batches of Q=32 through ``match_topk_batch``
   (warm-up, blocking loop) and a depth-3 ``match_topk_batch_async``
   pipeline, each with every launch and route counter set to 0 just
   before and read just after, each asserting that its kernels launched:
   bench.py's fuzzy batch (1M partial-match rows, median length 64,
   k=2048; colstream fuzzy), a literal batch of 2-4-byte pieces under ^,
   $, ' and ^...$ (colstream literal), bench.py's queries at max_typos=4
   (row-major, int16 lanes), the same under a scoring whose cells exceed
   int16 (row-major, int32 lanes), and 24-byte needles over a second
   1M-row partial-match corpus of that needle (row-major, int16 lanes);
   each finalizes through the row gather; then three unicode batches of Q=16 over the 1M-row Arabic
   corpus, recording their finalize routes: the 16 two-letter variants
   of "إن" (colstream fuzzy), the same under ', ^, $ and ^...$ (colstream
   literal), and 16 eight-codepoint needles at max_typos=4 (row-major);
3. timing phase: the launches of one more batch of each path, captured
   (``_build.CAPTURE``) and replayed per kernel — held bit-equal to its
   plain version on the same arguments, then timed (CUDA events, warmed
   up, queued behind a device sleep so host launch overhead leaves no
   gaps) beside the bound this run's data needs, its plain version and,
   for the row gather (ASCII and unicode paths apart, and per path),
   ``torch.index_select``; the fuzzy batch's colstream launches driven
   once more with ``int16_lanes=True`` (the int16 colstream kernel's
   path); and, on the same captured launches in 10 alternating rounds,
   the int16 and int32 instantiations of ``match_units`` (typo, long
   needle) and of the colstream fuzzy kernel (fuzzy): medians, the share
   of rounds the int16 one won, and the bound both share;
4. profile phase: torch.profiler over blocking fuzzy batches, ASCII and
   unicode (wall time, device busy time, top kernels and host
   operations) and cProfile over one ASCII batch;
5. card-versus-CPU phase: at 20k rows, Q=8, the (Q, 1+k, 2) serving
   arrays and the decoded top-k on the card equal the CPU's for fuzzy
   T=0 and T=1, literal, T=4 and long-needle batches, for Arabic and
   Korean codepoint corpora (fuzzy T=0, T=1, literal, T=4), and for ASCII
   needles under UnicodeMatching.ALWAYS over a mixed-script corpus.

Prints the card's name and power limit first, one JSON ``kernels`` line
before the last, and ``{"ok": true, "device": {...}}`` last. Exits
non-zero, printing no result, when there is no CUDA device or any phase
fails. Details (per-phase seconds, ptxas reports) go to
``chiprun_out/chip_smoke_detail.json``.
"""

import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

N_ROWS = 1_000_000
MEDIAN_LEN = 64
Q = 32
TOP_K = 2048
DEPTH, RUNS = 3, 10

# H100 SXM peaks: device memory rate (NVIDIA data sheet), and the 32-bit
# integer ALU rate = 64 operations per SM per clock (add, compare,
# min/max, bitwise on sm_90: CUDA C++ guide's throughput table; the 128
# lanes per SM are the float32 pipe) x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# cycles of torch.cuda._sleep per second at the H100 SXM's boost clock
SLEEP_CYCLES_PER_S = 1.98e9
INT64_MAX = (1 << 63) - 1  # the key of an unmatched row
# int32 operations of the colstream fuzzy kernel, each instruction one
# (corpus loads are counted as bytes): the T=0 greedy embedding per
# column, for n >= GREEDY_LOOKUP_FROM independent of n (2 compares and an
# or for each of the window's first and last needle unit, the bound
# test, 2 shared loads of the next needle unit, 2 compares, or, add; 4
# for the first-hit and 2 for the last-hit tracking; the byte offset),
# for shorter needles per unit (2 compares, or, compare, and, or) plus
# the add, the tracking and the byte offset; the minimal-position
# prefilter per (column, needle unit) cell (2 compares, or, the window's
# start and end tests, and per budget state a compare, and, or); the SW
# DP per (column, needle unit) cell of a matched row's trimmed window (2
# compares and an or for the unit match, 2 selects of hit or mismatch,
# select and subtract of the left gap, the two DPX add-max instructions,
# the up gap's select)
GREEDY_LOOKUP_FROM = 4
PF_GREEDY_OPS_PER_COLUMN = 20
PF_GREEDY_OPS_PER_CELL_SHORT = 6
PF_GREEDY_OPS_PER_COLUMN_SHORT = 8
PF_DP_OPS_PER_CELL = 5
PF_DP_OPS_PER_STATE = 3
SW_OPS_PER_CELL = 10
# colstream literal kernel: per (column, needle unit) cell (2 compares,
# or, and with the run before, the case select, add, the run select) and
# per column (the bonus's 2 selects and add, the case-bonus add, the
# first column's prefix select, the completion test, the loop's add and
# compare); a codepoint row's start-byte select a cell and byte-offset
# step a column are not counted
LIT_OPS_PER_CELL = 7
LIT_OPS_PER_COLUMN = 8
# a matched codepoint row's byte-count walk past an exact or prefix run:
# load, length extract, add
LIT_OPS_PER_REST = 3
# row-major kernel, per column of a live row's prefilter: table load,
# byte extract and the window tests, plus 3 per DP state (shift-test,
# add, closure max) at T > 0; per SW cell: 3 bit tests (unit match,
# case match, previous column's match), 3 selects (case bonus, hit or
# mismatch, left gap), add, subtract, the up move's gap select and the
# two DPX add-max instructions that carry the serial path
RM_PF_OPS_PER_COLUMN = 6
RM_PF_OPS_PER_STATE = 3
RM_SW_OPS_PER_CELL = 11

LITERAL_WRAP = (("'", ""), ("^", ""), ("", "$"), ("^", "$"))
TYPO_BUDGET = 4
LONG_NEEDLE = "deadbeefcafebabefacefeed"

# unicode batches: the reference's unicode_arabic_1m corpus (its
# calibrated Arabic sentence generator at 1M rows) and its 16 two-letter
# serving variants per script
UQ = 16
UNICODE_VARIANTS = {
    "arabic": ["إن", "لا", "ما", "في", "من", "هل", "ان", "نم",
               "إذ", "لم", "لن", "كي", "قد", "بل", "أو", "ثم"],
    "korean": ["니다", "하다", "있다", "없다", "보다", "가다", "오다", "주다",
               "사다", "살다", "쓰다", "자다", "차다", "타다", "크다", "따다"],
}
UNICODE_NEEDLE = {"arabic": "إن", "korean": "니다"}
# colstream plain versions run on the first groups of each bucket
PLAIN_GROUPS = 48
# row-major plain versions run on at most this many live rows per query
PLAIN_ROWS = 65536
# the row-major kernel's template boundaries the kernel phase checks, on
# a bucket of this many rows of this width
RM_BOUNDARY_N = (8, 16, 17, 24, 32, 33, 64)
RM_BOUNDARY_T = (0, 1, 2, 3, 4, 5, 8)
RM_BOUNDARY_B, RM_BOUNDARY_W = 640, 128
# row widths (4-byte words) the row gather is checked at
GATHER_CHECK_C = (128, 256, 384, 2048)
# the colstream kernels' tile boundaries the kernel phase checks: every
# bucket width (each tile size and shared-memory size the geometry
# picks) on 3 groups, where every query gets blocks of its own, Q at 1,
# 2, 17 and 33 in turn; and buckets whose blocks share a tile among 5 of
# 17 queries, all 32 (the most a block serves) and 17 of 33; needle
# lengths at their edges
TILE_BOUNDARY_W = (16, 32, 64, 128, 256, 512, 1024)
# (W, groups, Q)
TILE_BOUNDARY_SHARED = ((32, 40, 17), (16, 160, 32), (16, 160, 33))
TILE_BOUNDARY_Q = (1, 2, 17, 33)
TILE_BOUNDARY_FUZZY = ((1, 0), (16, 1), (5, 3), (2, None), (8, 0),
                       (2, 1), (3, 1), (16, 0), (7, 2))  # (n, T)
TILE_BOUNDARY_LIT_N = (1, 2, 16)
# the int16-lane kernels' pairing boundaries: live counts that leave an
# odd row out, a single pair, a warp and a bit
PAIR_COUNTS = (1, 2, 31, 33, 129, 603)
PAIR_COLSTREAM_COUNTS = (1, 2, 33, 1025, 3 * 1024 - 37)
# a user scoring whose cells exceed int16 at the typo batch's needles
# (8 x 4008 + 20 > 30000): the reference serves it in int32 lanes, so the
# row-major kernel's int32 byte instantiation keeps a serving path
WIDE_SCORING = dict(match_score=4000)
# rounds of the int16-against-int32 A/B on the captured launches
AB_ROUNDS = 10


def _queries(q, base="deadbeef"):
    """bench.py's queries: distinct permutations of "deadbeef" (or of
    ``base``), the base first."""
    rng = np.random.default_rng(99)
    out = [base]
    while len(out) < q:
        s = "".join(rng.permutation(list(base)))
        if s not in out:
            out.append(s)
    return out[:q]


def _literal_queries(q):
    """2-4-byte pieces of the bench permutations under ' (substring), ^
    (prefix), $ (suffix) and ^...$ (exact), in turn."""
    out = []
    for i, perm in enumerate(_queries(q)):
        pre, post = LITERAL_WRAP[i % 4]
        out.append(pre + perm[i % 3:i % 3 + 2 + i % 3] + post)
    return out


def _unicode_queries(q, script="arabic", kind="fuzzy"):
    """The script's two-letter variants; under ', ^, $ and ^...$ in turn
    (literal); or each the concatenation of ``kind`` consecutive variants
    (an int: 4 gives eight-codepoint needles)."""
    base = UNICODE_VARIANTS[script]
    if kind == "fuzzy":
        return base[:q]
    if kind == "literal":
        return [LITERAL_WRAP[i % 4][0] + base[i] + LITERAL_WRAP[i % 4][1]
                for i in range(q)]
    return ["".join(base[(i + j) % len(base)] for j in range(kind))
            for i in range(q)]


def _unicode_corpus(num_samples, script="arabic", seed=42):
    from frizbee_tpu_torch import datagen

    return datagen.unicode_corpus(script, needle=UNICODE_NEEDLE[script],
                                  num_samples=num_samples, seed=seed)


def _long_corpus(num_samples, seed=42):
    """The reference's Partial Match dataset (5% full, 20% partial,
    median 64) generated for the 24-byte needle."""
    from frizbee_tpu_torch import datagen

    return datagen.generate_haystack(LONG_NEEDLE, datagen.HaystackGenerationOptions(
        seed=seed, partial_match_percentage=0.20, match_percentage=0.05,
        median_length=MEDIAN_LEN, std_dev_length=MEDIAN_LEN // 4,
        num_samples=num_samples,
    ))


def _time_ms(fn, reps=5, warm=2):
    """Mean device time of fn() in ms, CUDA events around ``reps`` calls.
    The calls queue behind a device sleep that outlasts their enqueue, so
    the host's launch overhead leaves no gaps between them on the card
    (a small launch can be quicker on the card than its Python wrapper
    on the host)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * reps * host_s * SLEEP_CYCLES_PER_S) + 10_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a, b):
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def _needles(queries, cfg=None):
    from frizbee_tpu_torch.matcher import Matcher

    return np.stack([
        np.concatenate(Matcher.from_query(q, cfg)._compiled[0].engine
                       ._host_needle()[:2])
        for q in queries
    ])


def _flags(blk_bits, needles_q, T):
    from frizbee_tpu_torch.ops.presence import (
        needle_need_matrix,
        presence_hits,
    )

    need, tot = needle_need_matrix(needles_q)
    return (presence_hits(blk_bits, need) >= (tot - T)[None, :]).T.to(
        torch.int32
    ).contiguous()


def kernel_phase(corpus, detail):
    """Each kernel against its plain version on the card, bit-equal."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    nq = torch.from_numpy(_needles(_queries(Q))).to(dev)
    errs = {entry[0]: 0.0 for entry in KERNELS}
    checks = 0
    for b in corpus.buckets:
        cpT, nuT, idxT, blk, _ctxT = b.device_arrays_colstream()
        scal = pack_needle_scalars(nq, b.size)
        for T, nopre in ((0, False), (1, False), (0, True)):
            flags = _flags(blk, nq, T)
            for fl in (flags, None):
                for ix in (idxT, None):
                    # the int16 instantiation with flags and keys, and
                    # with neither
                    i16s = (False, True) if (fl is None) == (ix is None) \
                        else (False,)
                    for i16 in i16s:
                        kw = dict(W=b.width, n=8, max_typos=T,
                                  scoring=DEFAULT_SCORING, no_prefilter=nopre,
                                  idx_bits=idx_bits, int16_lanes=i16)
                        got = cs.match_units_colstream(cpT, nuT, scal, fl,
                                                       ix, **kw)
                        torch.cuda.synchronize()
                        want = cs.match_units_colstream_plain(
                            cpT, nuT, scal, fl, ix, **kw)
                        _check_equal(
                            errs, "colstream_fuzzy_i16" if i16
                            else "colstream_fuzzy", got, want,
                            f"w{b.width} T={T} no_prefilter={nopre} "
                            f"flags={fl is not None} keys={ix is not None} "
                            f"int16_lanes={i16}")
                        checks += 1
                        del got, want
    gather_shapes = _gather_shapes(corpus)
    rg = _row_gather_checks(dev, errs, gather_shapes)
    lit = _literal_kernel_checks(corpus, errs)
    rm = _rowmajor_kernel_checks(corpus, errs)
    rmx = _rowmajor_boundary_checks(dev, errs)
    tbx = _tile_boundary_checks(dev, errs)
    px = _pairing_checks(dev, errs)
    checks += rg + lit + rm + rmx + tbx + px
    detail["kernel_checks"] = checks
    print(f"kernel phase: {checks} kernel-vs-plain checks bit-equal "
          f"(colstream fuzzy Q={Q} x {len(corpus.buckets)} buckets x "
          f"T=0,1,none x flags x key-emit; colstream literal {lit}: "
          f"buckets x 4 modes x flags x key-emit; match_units {rm}: "
          f"buckets x (n=8,T=4),(n=24,T=0),(n=24,none) x all rows / "
          f"random row order; match_units {rmx} at the template "
          f"boundaries: n {RM_BOUNDARY_N} x T {RM_BOUNDARY_T} x bytes, "
          f"codepoints x columns, key-emit; colstream fuzzy and literal "
          f"{tbx} at the tile boundaries: W {TILE_BOUNDARY_W} and "
          f"{TILE_BOUNDARY_SHARED} x Q {TILE_BOUNDARY_Q} x bytes, "
          f"codepoints x columns, key-emit; int16 lanes of both at the "
          f"serving shapes, the template and tile boundaries and {px} "
          f"pairing boundaries: live counts {PAIR_COUNTS} / "
          f"{PAIR_COLSTREAM_COUNTS}; row_gather {rg}: C "
          f"{GATHER_CHECK_C} x M 1, 7, served {gather_shapes})",
          flush=True)
    return errs


def _row_gather_checks(dev, errs, gather_shapes):
    """The row gather against its plain version at every row width it
    has a path for (C = 128 a generic vector a lane, 256 the tournament's,
    384 three, 2048 the capped finalize's) and M = 1, 7 and a served size
    (the capped gather's at C=2048, the tournament's elsewhere), over R
    served rows, the ids including 0 and R-1."""
    from frizbee_tpu_torch.ops import colstream as cs

    g = torch.Generator(device=dev).manual_seed(5)
    checks = 0
    for C in GATHER_CHECK_C:
        R, _c, M_served = gather_shapes["capped" if C == 2048 else "broad"]
        data = torch.randint(-(2**31), 2**31 - 1, (R, C), generator=g,
                             dtype=torch.int32, device=dev)
        cases = [torch.tensor([0]), torch.tensor([R - 1])]
        for M in (7, M_served):
            rows = torch.randint(0, R, (M,), generator=g, device=dev)
            rows[0], rows[-1] = 0, R - 1
            cases.append(rows)
        for rows in cases:
            rows = rows.to(device=dev, dtype=torch.int32)
            _check_equal(errs, "row_gather", cs.row_gather(data, rows),
                         cs.row_gather_plain(data, rows),
                         f"C={C} M={rows.numel()} R={R}")
            checks += 1
        del data
    return checks


def _boundary_bucket(rng, n, T, unicode):
    """(cp (B, W), n_units (B,), needle orig + flip (2n,)) of a bucket
    whose first block of rows all carry the needle with at most T units
    dropped (all matched), whose second block holds no needle unit (all
    rejected at T < n), and whose other blocks mix both in every warp,
    over row lengths 0..W. Byte rows or codepoints of 1-4 UTF-8 bytes."""
    B, W = RM_BOUNDARY_B, RM_BOUNDARY_W
    if unicode:
        pool = np.array([0x0627, 0x0644, 0x0645, 0x0646, 0x0647, 0x0648,
                         0x61, 0x62, 0x43])
        filler = np.array([0xAC00, 0xAC01, 0xE9, 0x1F600, 0x10348, 0x2F,
                           0x78, 0x59])
    else:
        pool = np.frombuffer(b"abcdefghABCDEFGH", np.uint8).astype(np.int64)
        filler = np.frombuffer(b"qrstuvwxyzQRSTUVWXYZ0123456789/_-",
                               np.uint8).astype(np.int64)

    def swapcase(u):
        upper = (u >= 0x41) & (u <= 0x5A)
        lower = (u >= 0x61) & (u <= 0x7A)
        return np.where(upper, u + 32, np.where(lower, u - 32, u))

    orig = rng.choice(pool, n)
    flip = swapcase(orig)
    cp = rng.choice(filler, (B, W))
    nu = rng.integers(0, W + 1, B)
    rb = max(32, min(128, (32768 // (4 * W if unicode else W)) & ~31))
    for r in range(rb, B):
        if r >= 2 * rb:
            sprinkle = rng.random(W) < 0.1
            cp[r, sprinkle] = rng.choice(pool, int(sprinkle.sum()))
    for r in list(range(rb)) + list(range(2 * rb, B)):
        if r >= 2 * rb and rng.random() < 0.3:
            continue
        drop = int(rng.integers(0, T + (1 if r < rb else 3)))
        keep = np.sort(rng.permutation(n)[:max(n - drop, 0)])
        units = np.where(rng.random(len(keep)) < 0.3, flip[keep], orig[keep])
        nu[r] = max(nu[r], len(units))
        pos = np.sort(rng.choice(nu[r], len(units), replace=False))
        cp[r, pos] = units
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    cp = cp.astype(np.int32 if unicode else np.uint8)
    if not unicode:
        cp = cp.view(np.int8)
    return cp, nu.astype(np.int32), np.concatenate([orig, flip])


def _rowmajor_boundary_checks(dev, errs):
    """The row-major kernel against its plain version at every template
    boundary: needle lengths RM_BOUNDARY_N (NMAX 16, 32, 64 and their
    edges) x typo budgets RM_BOUNDARY_T (the greedy embedding, TMAX 1, 2,
    4, 8 and the budgets between), byte and codepoint rows, in columns
    mode (identity order) and key-emit mode (the identity order for one
    query, a random order for the other), two queries with their own live
    counts over :func:`_boundary_bucket`'s blocks."""
    from frizbee_tpu_torch.ops import kernels as km

    rng = np.random.default_rng(23)
    scorings = (km.DEFAULT_SCORING, (10, 3, 1, 2, 7, 5, 2, 6, 9))
    B = RM_BOUNDARY_B
    counts = (B - 37, B // 3 + 5)
    checks = 0
    for unicode in (False, True):
        for n in RM_BOUNDARY_N:
            for T in RM_BOUNDARY_T:
                cp_np, nu_np, needle = _boundary_bucket(rng, n, T, unicode)
                cp = torch.from_numpy(cp_np).to(dev)
                nu = torch.from_numpy(nu_np).to(dev)
                nq = torch.from_numpy(np.stack([needle, needle])).to(dev)
                idx = torch.from_numpy(rng.permutation(B).astype(np.int32))
                idx[torch.from_numpy(rng.random(B) < 0.05)] = -1
                idx = idx.to(dev)
                rows = torch.from_numpy(np.stack([
                    np.arange(B), rng.permutation(B)]).astype(np.int32)).to(
                        dev)
                for i16 in (False, True) if not unicode else (False,):
                    kw = dict(n=n, max_typos=T,
                              scoring=scorings[(n + T) % 2], idx_bits=10,
                              int16_lanes=i16)
                    checks += _rowmajor_pair_check(
                        errs, cp, nu, nq, idx, rows, counts, kw,
                        f"{'codepoints' if unicode else 'bytes'} n={n} "
                        f"T={T} int16_lanes={i16}")
    return checks


def _rowmajor_pair_check(errs, cp, nu, nq, idx, rows, counts, kw, what):
    """One bucket through match_units in columns mode (identity order)
    and key-emit mode (``rows``), each query q at live count counts[q],
    against the plain version's columns of every row; returns 2."""
    from frizbee_tpu_torch.ops import kernels as km

    B = cp.shape[0]
    entry = "match_units_i16" if kw.get("int16_lanes") else "match_units"
    scal = km.pack_needle_scalars(nq, B)
    want = km.match_units_plain(cp, nu, scal, **kw)
    scal[:, 0] = torch.tensor(counts)
    got = km.match_units(cp, nu, scal, **kw)
    torch.cuda.synchronize()
    want_cols = torch.zeros_like(want)
    want_keys = torch.full((len(counts), B), INT64_MAX, dtype=torch.int64,
                           device=cp.device)
    for q, c in enumerate(counts):
        want_cols[q, :c] = want[q, :c]
        sel = rows[q, :c].to(torch.int64)
        w = want[q, sel]
        want_keys[q, :c] = km.pack_keys(
            w[:, 0], w[:, 1], w[:, 2], w[:, 3], w[:, 4], idx[sel],
            kw["idx_bits"])
    _check_equal(errs, entry, got, want_cols, what + " columns")
    got = km.match_units(cp, nu, scal, rows, idx, **kw)
    torch.cuda.synchronize()
    _check_equal(errs, entry, got, want_keys, what + " keys")
    return 2


def _pairing_checks(dev, errs):
    """The int16-lane kernels at their pairing boundaries. Row-major: on
    :func:`_boundary_bucket`'s blocks (all matched, all rejected, mixed)
    with a tenth of the rows emptied and a tenth filled to W units, live
    counts PAIR_COUNTS for the two queries in turn, so a block's queue
    ends on an odd row out, holds one pair or one row, or crosses a warp;
    (n, T) at the greedy embedding and the DP, bytes, both modes.
    Colstream: a 3-group bucket whose group 1 holds empty rows but for a
    few W-unit ones (an empty row pairs with a full one) and whose group
    2 holds rows of one length that alternate between carrying the needle
    and not (a matched half beside a rejected one), live counts
    PAIR_COLSTREAM_COUNTS, T = 0 and 1, both modes. Returns the number of
    checks."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km

    rng = np.random.default_rng(41)
    B, W = RM_BOUNDARY_B, RM_BOUNDARY_W
    checks = 0
    for n, T in ((8, 0), (8, 4), (24, 0), (24, 4)):
        cp_np, nu_np, needle = _boundary_bucket(rng, n, T, False)
        r = rng.random(B)
        nu_np = np.where(r < 0.1, 0, np.where(r > 0.9, W, nu_np))
        nu_np = nu_np.astype(np.int32)
        cp = torch.from_numpy(cp_np).to(dev)
        nu = torch.from_numpy(nu_np).to(dev)
        nq = torch.from_numpy(np.stack([needle, needle])).to(dev)
        idx = torch.from_numpy(rng.permutation(B).astype(np.int32)).to(dev)
        rows = torch.from_numpy(np.stack([
            np.arange(B), rng.permutation(B)]).astype(np.int32)).to(dev)
        for i in range(0, len(PAIR_COUNTS), 2):
            counts = PAIR_COUNTS[i:i + 2]
            kw = dict(n=n, max_typos=T, scoring=km.DEFAULT_SCORING,
                      idx_bits=10, int16_lanes=True)
            checks += _rowmajor_pair_check(
                errs, cp, nu, nq, idx, rows, counts, kw,
                f"pairing n={n} T={T} counts={counts}")

    # the colstream bucket, built row by row (pack_corpus would cluster
    # the rows): group 0 random rows; group 1 empty rows but for three of
    # W units a 256-row tile (two carry the needle, one does not), so an
    # empty row pairs with a full one; group 2 rows of 12 units, the even
    # ones without the needle and the odd ones with it
    needle, Wc, Bc = "dEadbeEf", 32, 3 * 1024
    cpc = np.zeros((Bc, Wc), np.uint8)
    nuc = np.zeros(Bc, np.int32)
    for i in range(Bc - 37):
        g, t = i // 1024, i % 256
        if g == 0:
            row = "".join(rng.choice(list("deabfx/_Q"),
                                     int(rng.integers(0, Wc + 1))))
        elif g == 1:
            row = {5: "x" * 24 + needle, 77: "q" * Wc,
                   200: needle + "_" * 24}.get(t, "")
        else:
            row = ("ab" + needle + "yz") if i % 2 else "abqqqqqqqqyz"
        units = np.frombuffer(row.encode(), np.uint8)
        cpc[i, :len(units)] = units
        nuc[i] = len(units)
    cpT = torch.from_numpy(np.ascontiguousarray(
        cpc.view(np.int8).reshape(3, 1024, Wc).transpose(0, 2, 1)
    ).reshape(3 * Wc, 8, 128)).to(dev)
    nuT = torch.from_numpy(nuc.reshape(24, 128)).to(dev)
    idxc = rng.permutation(Bc).astype(np.int32)
    idxc[Bc - 37:] = -1
    idxT = torch.from_numpy(idxc).to(dev)
    idx_bits = 12
    nq = torch.from_numpy(_needles([needle, needle.swapcase()])).to(dev)
    for T in (0, 1):
        for count in PAIR_COLSTREAM_COUNTS:
            scal = km.pack_needle_scalars(nq, count)
            kw = dict(W=Wc, n=len(needle), max_typos=T,
                      scoring=km.DEFAULT_SCORING, idx_bits=idx_bits,
                      int16_lanes=True)
            for ix in (idxT, None):
                got = cs.match_units_colstream(cpT, nuT, scal, None, ix, **kw)
                torch.cuda.synchronize()
                want = cs.match_units_colstream_plain(cpT, nuT, scal, None,
                                                      ix, **kw)
                _check_equal(errs, "colstream_fuzzy_i16", got, want,
                             f"pairing T={T} count={count} "
                             f"keys={ix is not None}")
                checks += 1
    return checks



def _tile_boundary_bucket(rng, W, groups, unicode):
    """A W-wide colstream bucket of ``groups`` 1024-row groups (the last
    one partly padding) and a 16-unit needle: rows of 0 to W units (some
    0, some exactly W, most short) over the needle's letters in both
    cases, delimiters, digits and, for codepoints, 2-4-byte units; a
    fifth of them are a prefix of the needle, or start, end or hold one."""
    from frizbee_tpu_torch import pack_corpus

    letters = "abcdefghABCDEFGH" + ("éنإ한" if unicode else "")
    alpha = np.array(list(letters + "/_-.0123" + ("€😀𐍈" if unicode
                                                   else "")))
    needle = "".join(rng.choice(list(letters), 16))
    rows = []
    for i in range(groups * 1024 - 37):
        r = rng.random()
        L = W if r < 0.03 else 0 if r < 0.06 else int(
            rng.integers(1, min(W, 40) + 1))
        row = "".join(rng.choice(alpha, L))
        piece = needle[:(1, 2, 16, int(rng.integers(1, 17)))[i % 4]]
        kind = i % 25
        if kind == 0:
            row = piece
        elif kind in (1, 2):
            row = (piece + row)[:W]
        elif kind == 3:
            row = (row + piece)[-W:]
        elif kind == 4 and L > len(piece):
            at = int(rng.integers(0, L - len(piece)))
            row = row[:at] + piece + row[at + len(piece):]
        rows.append(row)
    corpus = pack_corpus(rows, unicode=unicode, bucket_widths=(W,))
    (b,) = corpus.buckets
    return b, needle, max((len(corpus) - 1).bit_length(), 1)


def _tile_boundary_checks(dev, errs):
    """Both colstream kernels against their plain versions at the tile
    boundaries: every bucket width (TILE_BOUNDARY_W, 3 groups) and the
    query-sharing buckets (TILE_BOUNDARY_SHARED), byte and codepoint rows
    with the ctx plane, Q cycling through TILE_BOUNDARY_Q, in key-emit
    and five-column mode; flags keep group 0 alive for every query, group
    1 for the first only and group 2 for none (or flags off), and odd
    queries' live count ends in the middle of group 1. Fuzzy (n, T) cycle
    through TILE_BOUNDARY_FUZZY and a literal mode through the four; on
    the 32-wide bucket all four literal modes at n = 1, 2, 16. Returns
    the number of checks."""
    from frizbee_tpu_torch import Config, UnicodeMatching
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import (
        DEFAULT_SCORING,
        pack_needle_scalars,
    )
    from frizbee_tpu_torch.ops.literal import LITERAL_MODES

    rng = np.random.default_rng(31)
    cases = [(W, 3, TILE_BOUNDARY_Q[i % len(TILE_BOUNDARY_Q)])
             for i, W in enumerate(TILE_BOUNDARY_W)]
    cases += list(TILE_BOUNDARY_SHARED)
    checks = 0
    for unicode in (False, True):
        name = "_unicode" if unicode else ""
        cfg = Config(unicode=UnicodeMatching.ALWAYS) if unicode else None
        for ci, (W, groups, Q) in enumerate(cases):
            b, needle, idx_bits = _tile_boundary_bucket(rng, W, groups,
                                                        unicode)
            cpT, nuT, idxT, _blk, ctxT = b.device_arrays_colstream()
            nG = cpT.shape[0] // W
            geo = cs.tile_geometry(W, 5 if unicode else 1, nG, Q)
            flags = torch.zeros((Q, nG), dtype=torch.int32, device=dev)
            flags[:, 0] = 1
            flags[0, 1] = 1
            flags[:, 3:] = 1
            flags = flags if ci % 3 else None

            def queries(n):
                out = []
                for _ in range(Q):
                    q = list(needle[:n])
                    for i in np.flatnonzero(rng.random(n) < 0.3):
                        q[i] = q[i].swapcase()
                    out.append("".join(q))
                return out

            def scalars(n):
                nq = torch.from_numpy(_needles(queries(n), cfg)).to(dev)
                scal = pack_needle_scalars(nq, b.size)
                scal[1::2, 0] = 1024 + 517
                return scal

            n, T = TILE_BOUNDARY_FUZZY[ci % len(TILE_BOUNDARY_FUZZY)]
            fuzzy_kw = dict(W=W, n=n, max_typos=T or 0,
                            no_prefilter=T is None, scoring=DEFAULT_SCORING,
                            idx_bits=idx_bits)
            runs = [("colstream_fuzzy" + name, scalars(n), fuzzy_kw)]
            if not unicode:
                # the int16 instantiation: its own geometry (two rows a
                # thread) at every width
                runs.append(("colstream_fuzzy_i16", scalars(n),
                             dict(fuzzy_kw, int16_lanes=True)))
            lit = [(LITERAL_MODES[ci % 4], TILE_BOUNDARY_LIT_N[ci % 3])]
            if W == 32 and groups == 3:
                lit = [(m, k) for m in LITERAL_MODES
                       for k in TILE_BOUNDARY_LIT_N]
            for mode, k in lit:
                runs.append(("colstream_literal" + name, scalars(k), dict(
                    W=W, n=k, mode=mode,
                    needle_byte_len=len(needle[:k].encode()),
                    scoring=DEFAULT_SCORING, idx_bits=idx_bits)))
            for entry, scal, kw in runs:
                plain = (cs.match_units_colstream_plain if "fuzzy" in entry
                         else cs.match_units_colstream_literal_plain)
                for ix in (idxT, None):
                    got = cs.match_units_colstream(cpT, nuT, scal, flags,
                                                   ix, ctxT, **kw)
                    torch.cuda.synchronize()
                    want = plain(cpT, nuT, scal, flags, ix, ctxT, **kw)
                    _check_equal(errs, entry, got, want,
                                 f"tile boundary w{W} groups={nG} Q={Q} "
                                 f"{geo} {kw} flags={flags is not None} "
                                 f"keys={ix is not None}")
                    checks += 1
            del cpT, nuT, idxT, ctxT, b
    return checks


def _group_slice(t, groups, per_group):
    return None if t is None else t[:groups * per_group]


def unicode_kernel_phase(ucorpus, errs, detail):
    """The unicode variant of each match kernel against its plain version
    on the card, bit-equal, on every bucket of the Arabic corpus at Q=16:
    the colstream kernels with the ctx plane (fuzzy at T=0, T=1 and with
    no prefilter, literal in all four modes; flags and key-emit on and
    off), the plain versions on the first PLAIN_GROUPS groups; the
    row-major kernel at (n=8, T=4) through a random row order in key-emit
    mode and at (n=20, T=0) in five-column mode, on at most PLAIN_ROWS
    live rows. Then the same kernels on a w512 block of 2-4-byte rows
    whose windows exceed 1024 bytes, which must set the greedy bit."""
    from frizbee_tpu_torch import Config, UnicodeMatching
    from frizbee_tpu_torch import pack_corpus
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km
    from frizbee_tpu_torch.ops.literal import LITERAL_MODES

    dev = ucorpus.device
    sc = km.DEFAULT_SCORING
    nq = torch.from_numpy(_needles(_unicode_queries(UQ))).to(dev)
    nbl = len(UNICODE_VARIANTS["arabic"][0].encode())
    g = torch.Generator(device=dev).manual_seed(11)
    counts = {"colstream_fuzzy_unicode": 0, "colstream_literal_unicode": 0,
              "match_units_unicode": 0}

    def colstream_checks(b, nq, n, idx_bits, fuzzy_cases, literal=True):
        cpT, nuT, idxT, blk, ctxT = b.device_arrays_colstream()
        W = b.width
        ng = min(cpT.shape[0] // W, PLAIN_GROUPS)
        sub = dict(cpT=_group_slice(cpT, ng, W), nuT=nuT[:ng * 8],
                   ctxT=_group_slice(ctxT, ng, W))
        scal = km.pack_needle_scalars(nq, b.size)
        cases = [("colstream_fuzzy_unicode", dict(
            W=W, n=n, max_typos=T, scoring=sc, no_prefilter=nopre,
            idx_bits=idx_bits)) for T, nopre in fuzzy_cases]
        if literal:
            cases += [("colstream_literal_unicode", dict(
                W=W, n=n, scoring=sc, mode=mode, needle_byte_len=nbl,
                idx_bits=idx_bits)) for mode in LITERAL_MODES]
        out = None
        for name, kw in cases:
            plain = (cs.match_units_colstream_plain if "fuzzy" in name
                     else cs.match_units_colstream_literal_plain)
            T = kw.get("max_typos", 0)
            flags = _flags(blk, nq, T)
            for fl in (flags, None):
                for ix in (idxT, None):
                    got = cs.match_units_colstream(cpT, nuT, scal, fl, ix,
                                                   ctxT, **kw)
                    torch.cuda.synchronize()
                    want = plain(sub["cpT"], sub["nuT"], scal,
                                 None if fl is None else fl[:, :ng],
                                 None if ix is None else ix[:ng * 1024],
                                 sub["ctxT"], **kw)
                    if ix is not None:
                        got_s = got[:, :ng * 1024]
                    else:
                        got_s = tuple(c[:, :ng * 1024] for c in got)
                    _check_equal(errs, name, got_s, want,
                                 f"w{W} {kw} flags={fl is not None} "
                                 f"keys={ix is not None}")
                    counts[name] += 1
                    if (name == "colstream_fuzzy_unicode" and T == 0
                            and not kw["no_prefilter"] and fl is None
                            and ix is None):
                        out = got  # five columns, T=0, no flags
                    del got, want, got_s
        return out

    def rowmajor_checks(b, queries, T, idx_bits):
        cp, nu, idx = b.device_arrays_units()
        nqr = torch.from_numpy(_needles(queries)).to(dev)
        n = nqr.shape[1] // 2
        order = torch.argsort(torch.rand((nqr.shape[0], b.size),
                                         generator=g, device=dev),
                              dim=1).to(torch.int32)
        kw = dict(n=n, max_typos=T, scoring=sc, idx_bits=idx_bits)
        for rows in (order, None) if T else (None,):
            scal = km.pack_needle_scalars(
                nqr, min(b.size if rows is None else b.size // 3 + 17,
                         PLAIN_ROWS))
            ix = None if rows is None else idx
            got = km.match_units(cp, nu, scal, rows, ix, **kw)
            torch.cuda.synchronize()
            want = km.match_units_plain(cp, nu, scal, rows, ix, **kw)
            _check_equal(errs, "match_units_unicode", got, want,
                         f"w{b.width} n={n} T={T} order={rows is not None}")
            counts["match_units_unicode"] += 1
            del got, want

    idx_bits = max((len(ucorpus) - 1).bit_length(), 1)
    for b in ucorpus.buckets:
        colstream_checks(b, nq, 2, idx_bits,
                         ((0, False), (1, False), (0, True)))
        rowmajor_checks(b, _unicode_queries(UQ, kind=4), TYPO_BUDGET,
                        idx_bits)
        rowmajor_checks(b, _unicode_queries(UQ, kind=10), 0, idx_bits)

    # long byte windows: 2-4-byte rows of a w512 block, the needle's first
    # letter at the start and the rest at the end
    rng = np.random.default_rng(13)
    pool = np.array([0x00E9, 0x0644, 0x20AC, 0xAC00, 0x1F600, 0x10348])
    rows = []
    for i in range(3000):
        n_units = int(rng.integers(2, 500))
        units = rng.choice(pool, n_units)
        row = "".join(map(chr, units))
        rows.append(("l" + row + "inux") if i % 3 else row)
    wide = pack_corpus(rows, unicode=True, bucket_widths=(512,))
    (wb,) = wide.buckets
    nql = torch.from_numpy(_needles(
        ["linux"] * 4, Config(unicode=UnicodeMatching.ALWAYS))).to(dev)
    cols = colstream_checks(wb, nql, 5, 12, ((0, False), (1, False)),
                            literal=False)
    n_greedy = int(cols[4].sum())
    max_end = int(cols[3].max())
    assert n_greedy > 0 and max_end > 1024, (n_greedy, max_end)
    rowmajor_checks(wb, ["linux"] * 4, TYPO_BUDGET, 12)
    detail["unicode_kernel_checks"] = dict(
        counts, w512_greedy_rows=n_greedy, w512_max_end_col=max_end)
    print(f"kernel phase, unicode: bit-equal checks {json.dumps(counts)} "
          f"(Arabic 1M rows, buckets "
          f"{[(b.width, b.size) for b in ucorpus.buckets]}, Q={UQ}; w512 "
          f"block: {n_greedy} greedy rows, end_col up to {max_end})",
          flush=True)


def _check_equal(errs, name, got, want, what):
    pairs = [(got, want)] if torch.is_tensor(got) else list(zip(got, want))
    for g, w in pairs:
        err = _max_abs_err(g, w)
        errs[name] = max(errs[name], err)
        if err:
            raise AssertionError(f"{name} kernel != plain: {what} err={err}")


def _literal_kernel_checks(corpus, errs):
    """The literal kernel on every bucket, 4 modes x flags x key-emit,
    for Q=32 3-byte pieces of the bench permutations."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars
    from frizbee_tpu_torch.ops.literal import LITERAL_MODES

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    nq = torch.from_numpy(_needles([p[:3] for p in _queries(Q)])).to(dev)
    checks = 0
    for b in corpus.buckets:
        cpT, nuT, idxT, blk, _ctxT = b.device_arrays_colstream()
        scal = pack_needle_scalars(nq, b.size)
        flags = _flags(blk, nq, 0)
        for mode in LITERAL_MODES:
            for fl in (flags, None):
                for ix in (idxT, None):
                    kw = dict(W=b.width, n=3, scoring=DEFAULT_SCORING,
                              mode=mode, needle_byte_len=3,
                              idx_bits=idx_bits)
                    got = cs.match_units_colstream(cpT, nuT, scal, fl, ix,
                                                   **kw)
                    torch.cuda.synchronize()
                    want = cs.match_units_colstream_literal_plain(
                        cpT, nuT, scal, fl, ix, **kw)
                    _check_equal(errs, "colstream_literal", got, want,
                                 f"w{b.width} {mode} flags={fl is not None}"
                                 f" keys={ix is not None}")
                    checks += 1
                    del got, want
    return checks


def _rowmajor_kernel_checks(corpus, errs):
    """The row-major kernel on every bucket for Q=32 queries: every row
    in five-column mode, and a third of the rows through a random row
    order per query in key-emit mode."""
    from frizbee_tpu_torch.ops import kernels as km

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    cases = (
        (_queries(Q), TYPO_BUDGET, False),
        (_queries(Q, LONG_NEEDLE), 0, False),
        (_queries(Q, LONG_NEEDLE), 0, True),
    )
    g = torch.Generator(device=dev).manual_seed(7)
    checks = 0
    for b in corpus.buckets:
        cp, nu, idx = b.device_arrays_ascii()
        order = torch.argsort(
            torch.rand((Q, b.size), generator=g, device=dev), dim=1
        ).to(torch.int32)
        for ci, (queries, T, nopre) in enumerate(cases):
            nq = torch.from_numpy(_needles(queries)).to(dev)
            n = nq.shape[1] // 2
            # the int16 instantiation through the row order on every case
            # and over all rows on the typo case
            runs = [(None, False), (order, False), (order, True)]
            if ci == 0:
                runs.append((None, True))
            for rows, i16 in runs:
                kw = dict(n=n, max_typos=T, scoring=km.DEFAULT_SCORING,
                          no_prefilter=nopre, idx_bits=idx_bits,
                          int16_lanes=i16)
                scal = km.pack_needle_scalars(
                    nq, b.size if rows is None else b.size // 3 + 17)
                ix = None if rows is None else idx
                got = km.match_units(cp, nu, scal, rows, ix, **kw)
                torch.cuda.synchronize()
                want = km.match_units_plain(cp, nu, scal, rows, ix, **kw)
                _check_equal(errs, "match_units_i16" if i16 else
                             "match_units", got, want,
                             f"w{b.width} n={n} T={T} no_prefilter={nopre}"
                             f" order={rows is not None} int16_lanes={i16}")
                checks += 1
                del got, want
        del order
    return checks


def _gather_shapes(corpus):
    """(R, C, M) of the row gather on the serving path: the capped
    finalize gathers cap of nG 1024-key groups per query (int64 keys as
    2048 int32 words), the tournament TOP_K of NB 128-key blocks."""
    from frizbee_tpu_torch.matcher import _colstream_finalize_cap
    from frizbee_tpu_torch.ops.batch import BROAD_TOPK_R

    n_g = sum(b.host_blk_bits().shape[0] for b in corpus.buckets)
    res = _colstream_finalize_cap(
        corpus, [(_needles(_queries(Q)), 0)], TOP_K)
    cap = res[0] if res is not None else -(-n_g // 4)
    nb = n_g * 1024 // BROAD_TOPK_R
    return {
        "capped": (Q * n_g, 2048, Q * cap),
        "broad": (Q * nb, 2 * BROAD_TOPK_R, Q * TOP_K),
    }


def _serve(label, corpus, queries, cfg, kernels, detail):
    """One serving path: match_topk_batch (warm-up, 3 blocking batches)
    and a depth-3 match_topk_batch_async pipeline, with every launch and
    route counter set to 0 just before and read just after; fails unless
    each kernel of ``kernels`` launched."""
    from frizbee_tpu_torch import match_topk_batch, match_topk_batch_async
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import batch as fb

    for counter in (_build.LAUNCHES, fb.FINALIZE_ROUTES,
                    fb.ROW_MAJOR_ROUTES):
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = match_topk_batch(queries, corpus, cfg, k=TOP_K)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = match_topk_batch(queries, corpus, cfg, k=TOP_K)
        times.append(time.perf_counter() - t0)
    blocking_s = float(np.median(times))
    t0 = time.perf_counter()
    futs = deque(match_topk_batch_async(queries, corpus, cfg, k=TOP_K)
                 for _ in range(DEPTH))
    done = 0
    for _ in range(RUNS):
        last = futs.popleft().result()
        done += 1
        futs.append(match_topk_batch_async(queries, corpus, cfg, k=TOP_K))
    while futs:
        last = futs.popleft().result()
        done += 1
    pipe_s = (time.perf_counter() - t0) / done
    batches = 1 + 3 + done
    launches = dict(_build.LAUNCHES)
    finalize_routes = dict(fb.FINALIZE_ROUTES)
    row_major_routes = dict(fb.ROW_MAJOR_ROUTES)
    peak = torch.cuda.max_memory_allocated()

    for r, p in zip(res, last):
        assert len(r[1]) == min(TOP_K, r[0]), f"{label}: result not k-capped"
        assert r[0] == p[0] and np.array_equal(r[1], p[1]), (
            f"{label}: pipelined result differs from blocking")
        assert np.all(np.diff(r[2]) <= 0), f"{label}: scores not sorted"
    for name in kernels:
        assert launches[name] > 0, (
            f"kernel {name} never launched on the {label} path")
    out = {
        "corpus_rows": len(corpus), "batch_queries": len(queries),
        "top_k": TOP_K, "max_typos": cfg.max_typos,
        "warmup_batch_seconds": warm_s,
        "blocking_batch_seconds": blocking_s,
        "blocking_haystacks_per_sec": len(queries) * len(corpus)
        / blocking_s,
        "pipelined_batch_seconds": pipe_s,
        "pipelined_haystacks_per_sec": len(queries) * len(corpus) / pipe_s,
        "batches": batches, "launches": launches,
        "finalize_routes": finalize_routes,
        "row_major_routes": row_major_routes,
        "peak_device_memory_bytes": peak,
        "match_counts": [int(r[0]) for r in res],
    }
    detail.setdefault("serving", {})[label] = out
    print(f"serving phase, {label}: " + json.dumps(
        {k: v for k, v in out.items() if k != "match_counts"}), flush=True)
    return out


def _paths(corpus, long_corpus, ucorpus):
    """The eight serving paths: label -> (corpus, queries, config, the
    kernels the path must launch). The ASCII row-major batches take the
    int16-lane instantiation, but typo_wide, whose scoring's cells exceed
    int16, takes the int32 one. The unicode batches record their finalize
    route without requiring one: most Arabic groups stay alive for any
    needle, so the capped route and its row gather may not run."""
    from frizbee_tpu_torch import Config
    from frizbee_tpu_torch.config import Scoring

    return {
        "fuzzy": (corpus, _queries(Q), Config(),
                  ("colstream_fuzzy", "row_gather")),
        "literal": (corpus, _literal_queries(Q), Config(),
                    ("colstream_literal", "row_gather")),
        "typo": (corpus, _queries(Q), Config(max_typos=TYPO_BUDGET),
                 ("match_units_i16", "row_gather")),
        "typo_wide": (corpus, _queries(Q), Config(
            max_typos=TYPO_BUDGET, scoring=Scoring(**WIDE_SCORING)),
            ("match_units", "row_gather")),
        "long_needle": (long_corpus, _queries(Q, LONG_NEEDLE), Config(),
                        ("match_units_i16", "row_gather")),
        "unicode_fuzzy": (ucorpus, _unicode_queries(UQ), Config(),
                          ("colstream_fuzzy",)),
        "unicode_literal": (ucorpus, _unicode_queries(UQ, kind="literal"),
                            Config(), ("colstream_literal",)),
        "unicode_typo": (ucorpus, _unicode_queries(UQ, kind=4),
                         Config(max_typos=TYPO_BUDGET), ("match_units",)),
    }


def serving_phase(paths, detail):
    """The eight serving paths, each read on its own."""
    serving = {
        label: _serve(label, c, queries, cfg, kernels, detail)
        for label, (c, queries, cfg, kernels) in paths.items()
    }
    main, typo = serving["fuzzy"], serving["typo"]
    assert main["match_counts"][0] > 0, "no match for the headline needle"
    assert sum(serving["literal"]["match_counts"]) > 0, (
        "no literal query matched")
    assert typo["row_major_routes"]["compacted"] == typo["batches"]
    assert typo["match_counts"][0] >= main["match_counts"][0]
    # the ASCII row-major batches went through the int16 instantiation
    # alone, the wide-scoring one through the int32 one alone, with the
    # same matches as the typo batch
    for label in ("typo", "long_needle"):
        launched = serving[label]["launches"]
        assert launched["match_units"] == 0, (label, launched)
        assert launched["match_units_i16"] > 0, (label, launched)
    wide = serving["typo_wide"]
    assert wide["launches"]["match_units_i16"] == 0
    assert wide["launches"]["match_units"] > 0
    assert wide["match_counts"] == typo["match_counts"]
    assert serving["long_needle"]["match_counts"][0] > 0, (
        "no match for the long needle")
    ufuzzy, utypo = serving["unicode_fuzzy"], serving["unicode_typo"]
    assert ufuzzy["match_counts"][0] > 0, "no match for the unicode needle"
    assert sum(serving["unicode_literal"]["match_counts"]) > 0, (
        "no unicode literal query matched")
    assert utypo["row_major_routes"]["compacted"] == utypo["batches"]
    assert utypo["match_counts"][0] > 0, "no unicode typo-budget match"
    return serving


def profile_phase(label, corpus, queries, detail, host_profile=False):
    """Where a serving batch's time goes: torch.profiler over blocking
    batches — wall time, device busy time, and the top device kernels
    and host operations; with ``host_profile``, cProfile over one more
    batch."""
    from torch.profiler import ProfilerActivity, profile

    from frizbee_tpu_torch import Config, match_topk_batch

    reps = 3
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            match_topk_batch(queries, corpus, Config(), k=TOP_K)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))

    # device-side events only (kernels, copies): the aten ops that
    # launched them carry the same time again
    dev_ops = sorted(
        (e for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=device_us, reverse=True,
    )
    busy_ms = sum(device_us(e) for e in dev_ops) / reps / 1e3
    host_ops = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)
    out = {
        "batch_queries": len(queries),
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "peak_device_memory_bytes": peak,
        "top_device_ms_per_batch": [
            [e.key[:80], device_us(e) / reps / 1e3, e.count // reps]
            for e in dev_ops[:10]
        ],
        "top_host_self_ms_per_batch": [
            [e.key[:80], e.self_cpu_time_total / reps / 1e3,
             e.count // reps]
            for e in host_ops[:12]
        ],
    }
    if host_profile:
        # host-side candidates: cProfile over one more batch (it slows
        # Python calls, so only the shares are read from it)
        import cProfile
        import pstats

        cprof = cProfile.Profile()
        cprof.enable()
        match_topk_batch(queries, corpus, Config(), k=TOP_K)
        torch.cuda.synchronize()
        cprof.disable()
        st = pstats.Stats(cprof)
        rows = sorted(
            ((v[3], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
             for k, v in st.stats.items()),
            reverse=True,
        )
        out["cprofile_top_cumulative_ms"] = [
            [name, sec * 1e3] for sec, name in rows[:25]
        ]
    detail.setdefault("profile", {})[label] = out
    print(f"profile phase, {label}: " + json.dumps({
        k: out[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                            "device_idle_share")
    }) + " top device: " + json.dumps(out["top_device_ms_per_batch"][:5]),
        flush=True)


def _time_once_ms(fn):
    """(device ms, result) of one call of fn(), CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _bound(in_bytes, out_bytes, ops):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and int32 operations over the ALU rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _colstream_work(args, kw, keys):
    """(int32 operations, bytes read, bytes written) that one colstream
    launch's data needs. A group runs for the queries whose live count
    and stage-1 flag keep it alive; each of its rows walks its unit
    columns (only the first n in exact and prefix mode, where a matched
    codepoint row then sums the byte lengths of the rest for its exact
    flag). A fuzzy row that passes the prefilter runs the DP over the
    units of its trimmed window (``colstream.colstream_window``,
    ``colstream_window_units``), n cells a unit. Bytes count each needed
    corpus unit (1 byte, or a 4-byte codepoint and its ctx-plane byte),
    and the unit count and index of each row of a group some query reads,
    once."""
    from frizbee_tpu_torch.corpus import GROUP_ROWS
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import PF_DP, PF_GREEDY, prefilter_mode
    from frizbee_tpu_torch.ops.literal import EXACT, PREFIX

    cpT, nuT, scal, flags, _idxT, ctxT = args
    W, n = kw["W"], kw["n"]
    unit_bytes = cpT.element_size() + (0 if ctxT is None else 1)
    nG = cpT.shape[0] // W
    g0 = torch.arange(nG, device=cpT.device) * GROUP_ROWS
    alive = g0[None, :] < scal[:, :1]
    if flags is not None:
        alive = alive & (flags > 0)
    alive = alive.to(torch.float64)
    walk = torch.clamp(nuT.reshape(nG, GROUP_ROWS), max=W)
    if kw.get("mode") in (EXACT, PREFIX):
        walk = torch.clamp(walk, max=n)
    group_cols = walk.sum(dim=1).to(torch.float64)
    cols = float((alive * group_cols[None, :]).sum())
    read = alive.amax(dim=0)
    in_bytes = (float((read * group_cols).sum()) * unit_bytes
                + float(read.sum()) * GROUP_ROWS * 8
                + 4 * (scal.numel() + (flags.numel() if flags is not None
                                       else 0)))
    out_bytes = 8 * keys.numel()
    if "mode" in kw:
        ops = cols * (LIT_OPS_PER_CELL * n + LIT_OPS_PER_COLUMN)
        if cpT.dtype == torch.int32 and kw["mode"] in (EXACT, PREFIX):
            hit = (keys != INT64_MAX).to(torch.float64)
            rest = torch.clamp(torch.clamp(nuT.reshape(-1), max=W) - n,
                               min=0).to(torch.float64)
            ops += float((hit * rest[None, :]).sum()) * LIT_OPS_PER_REST
            in_bytes += float((hit.amax(dim=0) * rest).sum()) * (
                1 if ctxT is not None else 4)
        return ops, in_bytes, out_bytes
    # fuzzy: the prefilter over every walked column; the DP over the
    # trimmed window of each alive row it passes
    T = min(int(kw["max_typos"]), n)
    pf = prefilter_mode(n, T, kw["no_prefilter"])
    if pf == PF_GREEDY:
        per_col = (PF_GREEDY_OPS_PER_COLUMN if n >= GREEDY_LOOKUP_FROM else
                   n * PF_GREEDY_OPS_PER_CELL_SHORT
                   + PF_GREEDY_OPS_PER_COLUMN_SHORT)
    elif pf == PF_DP:
        per_col = n * (PF_DP_OPS_PER_CELL + PF_DP_OPS_PER_STATE * (T + 1))
    else:
        per_col = 0
    matched, wstart, wend, _nb = cs.colstream_window(
        cpT, nuT, scal, ctxT, W=W, n=n, max_typos=T,
        no_prefilter=kw["no_prefilter"])
    units = cs.colstream_window_units(cpT, nuT, wstart, wend, ctxT, W=W)
    row_alive = alive.repeat_interleave(GROUP_ROWS, dim=1) > 0
    dp_units = float(torch.where(matched & row_alive, units, 0).sum(
        dtype=torch.float64))
    ops = cols * per_col + dp_units * n * SW_OPS_PER_CELL
    return ops, in_bytes, out_bytes


def _match_units_work(args, kw, out):
    """(int32 operations, bytes read, bytes written) that one row-major
    launch's data needs: each query's live rows (the first count of its
    row order) run the prefilter to their length, and the DP walks n
    cells a column over the trimmed window [max(start - 1, 0), end) of
    each matched row (every live row in columns mode), the window pass 1
    leaves (``kernels.prefilter_window``, ``kernels.window_units``).
    Bytes count each row some query reads (its units — 1 byte, or 4 for
    codepoints — unit count and index) once, the order entries read, the
    scalars and the output."""
    from frizbee_tpu_torch.ops import kernels as km

    cp, nu, scal, rows, idx = args
    B, W = cp.shape
    n = kw["n"]
    T = min(int(kw["max_typos"]), n)
    cnt = torch.clamp(scal[:, 0], 0, B)
    first = (torch.arange(B, device=cp.device)[None, :] < cnt[:, None])
    live = first if rows is None else torch.zeros_like(first).scatter_(
        1, rows.to(torch.int64), first)
    lens = torch.clamp(nu.to(torch.float64), max=W)
    live_cols = float((live.to(torch.float64) * lens[None, :]).sum())
    read = live.any(dim=0).to(torch.float64)
    in_bytes = (float((read * (lens * cp.element_size() + 8)).sum())
                + 4 * scal.numel()
                + (4 * float(cnt.sum()) if rows is not None else 0))
    pf_mode = km.prefilter_mode(n, T, kw["no_prefilter"])
    pf_per_col = 0 if pf_mode == km.PF_NONE else RM_PF_OPS_PER_COLUMN + (
        RM_PF_OPS_PER_STATE * (T + 1) if T else 0)
    dp_cols = 0.0
    sc = scal.cpu()
    for q, c in enumerate(cnt.tolist()):
        if c == 0:
            continue
        sel = (torch.arange(c, device=cp.device) if rows is None
               else rows[q, :c].to(torch.int64))
        hay, units = cp[sel], nu.reshape(-1)[sel]
        matched, ws, we, _nb = km.prefilter_window(
            hay, units, sc[q, 2:2 + n].tolist(),
            sc[q, 2 + km.MAX_KERNEL_NEEDLE:2 + km.MAX_KERNEL_NEEDLE + n]
            .tolist(), n=n, T=T, no_prefilter=kw["no_prefilter"])
        walked = km.window_units(hay, units, ws, we)
        if idx is not None:
            walked = walked[matched]
        dp_cols += float(walked.sum())
    ops = live_cols * pf_per_col + dp_cols * n * RM_SW_OPS_PER_CELL
    return ops, in_bytes, out.numel() * out.element_size()


def _gather_work(args, _kw, out):
    data, rows = args
    return 0.0, out.numel() * 4 + rows.numel() * 4, out.numel() * 4


def _contract_work(args, _kw, out):
    """The contract launch: its inputs read and outputs written once, an
    operation per output element."""
    read = sum(a.numel() * a.element_size() for a in args)
    written = sum(o.numel() * o.element_size() for o in out)
    return float(sum(o.numel() for o in out)), float(read), float(written)


def _replay(entry, name, calls, errs):
    """Time the captured launches ``calls`` ((args, kwargs) of the
    wrapper) of one serving batch on the kernel, on its plain version and
    on the library call where there is one; the kernel's results are held
    bit-equal to the plain version's. Returns the timing entry's numbers
    and the work this run's data needs."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import contract as ct
    from frizbee_tpu_torch.ops import kernels as km

    kernel, plain, work, library = {
        "colstream_fuzzy": (cs.match_units_colstream,
                            cs.match_units_colstream_plain,
                            _colstream_work, None),
        "colstream_literal": (cs.match_units_colstream,
                              cs.match_units_colstream_literal_plain,
                              _colstream_work, None),
        "match_units": (km.match_units, km.match_units_plain,
                        _match_units_work, None),
        "match_units_i16": (km.match_units, km.match_units_plain,
                            _match_units_work, None),
        "colstream_fuzzy_i16": (cs.match_units_colstream,
                                cs.match_units_colstream_plain,
                                _colstream_work, None),
        "lane_contract": (ct.lane_contract, ct.contract_plain,
                          _contract_work, None),
        "row_gather": (cs.row_gather, cs.row_gather_plain, _gather_work,
                       lambda data, rows: torch.index_select(data, 0, rows)),
    }[name]

    def run(fn):
        return [fn(*a, **kw) for a, kw in calls]

    got = run(kernel)
    plain_ms, want = _time_once_ms(lambda: run(plain))
    for g, w in zip(got, want):
        _check_equal(errs, entry, g, w, "serving shapes")
    ops = in_bytes = out_bytes = 0.0
    for (a, kw), out in zip(calls, got):
        o, i, w = work(a, kw, out)
        ops, in_bytes, out_bytes = ops + o, in_bytes + i, out_bytes + w
    del got, want
    bound_ms, bound_by = _bound(in_bytes, out_bytes, ops)
    return {
        "ms": _time_ms(lambda: run(kernel)),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": (None if library is None
                       else _time_ms(lambda: run(library))),
    }, {"launches": len(calls), "ops": ops, "bytes": in_bytes + out_bytes}


KERNELS = (
    # entry, kernel (its launch counter), source, TPU kernel it replaces,
    # paths it runs on (the unicode launches of the match kernels are
    # entries of their own; fuzzy_int16 drives the fuzzy batch's colstream
    # launches with int16 lanes, contract the contract phase)
    ("colstream_fuzzy", "colstream_fuzzy",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954", ("fuzzy",)),
    ("colstream_literal", "colstream_literal",
     "frizbee_tpu_torch/csrc/colstream_literal.cu",
     "frizbee_tpu/ops/colstream.py:954", ("literal",)),
    ("row_gather", "row_gather", "frizbee_tpu_torch/csrc/row_gather.cu",
     "frizbee_tpu/ops/colstream.py:749",
     ("fuzzy", "literal", "typo", "long_needle")),
    ("row_gather_unicode", "row_gather",
     "frizbee_tpu_torch/csrc/row_gather.cu",
     "frizbee_tpu/ops/colstream.py:749",
     ("unicode_fuzzy", "unicode_literal", "unicode_typo")),
    ("match_units", "match_units", "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632", ("typo_wide",)),
    ("match_units_i16", "match_units_i16",
     "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632", ("typo", "long_needle")),
    ("colstream_fuzzy_i16", "colstream_fuzzy_i16",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954", ("fuzzy_int16",)),
    ("lane_contract", "lane_contract",
     "frizbee_tpu_torch/csrc/lane_contract.cu",
     "tests/test_kernel_contract.py:52", ("contract",)),
    ("colstream_fuzzy_unicode", "colstream_fuzzy",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954", ("unicode_fuzzy",)),
    ("colstream_literal_unicode", "colstream_literal",
     "frizbee_tpu_torch/csrc/colstream_literal.cu",
     "frizbee_tpu/ops/colstream.py:954", ("unicode_literal",)),
    ("match_units_unicode", "match_units",
     "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632", ("unicode_typo",)),
)


def _capture(corpus, queries, cfg):
    """The launches, (kernel name, (args, kwargs) of its wrapper), of one
    serving batch."""
    from frizbee_tpu_torch import match_topk_batch
    from frizbee_tpu_torch.ops import _build

    _build.CAPTURE = []
    match_topk_batch(queries, corpus, cfg, k=TOP_K)
    calls, _build.CAPTURE = _build.CAPTURE, None
    return calls


def _drive(label, calls, serving):
    """A path of launches: every launch counter set to 0, the captured
    ``calls`` ((counter, (args, kwargs)) of the wrapper) run through
    their wrappers once, the counters read into ``serving[label]``."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import colstream as cs

    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    for _name, (a, kw) in calls:
        cs.match_units_colstream(*a, **kw)
    torch.cuda.synchronize()
    serving[label] = {"launches": dict(_build.LAUNCHES)}


def ab_phase(calls, detail):
    """Row 8's timing half: the int32 and int16 instantiations of
    ``match_units`` on the typo and long-needle batches' launches and of
    the colstream fuzzy kernel on the fuzzy batch's, in AB_ROUNDS rounds
    that alternate which goes first, each held bit-equal to the other
    first. Medians, the share of rounds the int16 one was faster, and the
    bound both share (the same work counted for both)."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km

    cases = {
        "match_units typo": ("typo", "match_units_i16", km.match_units,
                             _match_units_work),
        "match_units long_needle": ("long_needle", "match_units_i16",
                                    km.match_units, _match_units_work),
        "colstream_fuzzy fuzzy": ("fuzzy", "colstream_fuzzy",
                                  cs.match_units_colstream, _colstream_work),
    }
    out = {}
    for label, (path, name, fn, work) in cases.items():
        base = [c for k, c in calls[path] if k == name]
        variants = {
            lanes: [(a, dict(kw, int16_lanes=lanes == "int16"))
                    for a, kw in base]
            for lanes in ("int32", "int16")}

        def run(v):
            return [fn(*a, **kw) for a, kw in variants[v]]

        r32, r16 = run("int32"), run("int16")
        torch.cuda.synchronize()
        for x, y in zip(r32, r16):
            pairs = [(x, y)] if torch.is_tensor(x) else list(zip(x, y))
            for g, w in pairs:
                assert torch.equal(g, w), f"{label}: int16 != int32"
        ops = in_b = out_b = 0.0
        for (a, kw), res in zip(variants["int32"], r32):
            o, i, w = work(a, kw, res)
            ops, in_b, out_b = ops + o, in_b + i, out_b + w
        del r32, r16
        bound_ms, bound_by = _bound(in_b, out_b, ops)
        ms = {"int32": [], "int16": []}
        for r in range(AB_ROUNDS):
            for v in (("int32", "int16") if r % 2 == 0
                      else ("int16", "int32")):
                ms[v].append(_time_ms(lambda: run(v)))
        med = {v: float(np.median(t)) for v, t in ms.items()}
        out[label] = {
            "launches": len(base), "ms": ms,
            "median_ms": med,
            "int16_won_share": float(np.mean(
                np.array(ms["int16"]) < np.array(ms["int32"]))),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": {v: bound_ms / m for v, m in med.items()},
        }
        print(f"int16/int32 A/B, {label}: " + json.dumps(
            {k: v for k, v in out[label].items() if k != "ms"}), flush=True)
    detail["int16_ab"] = out
    return out


def timing_phase(paths, serving, errs, detail):
    """Each kernel's time at its serving shapes: the launches of one batch
    of each path it runs on, captured and replayed, beside their bound,
    their plain version and, for the row gather, ``torch.index_select``.
    The captures run after the serving phase has read its counters. The
    int16 colstream kernel's path drives the fuzzy batch's colstream
    launches with int16 lanes (counted on their own); then the int16/int32
    A/B on the same launches."""
    calls = {label: _capture(c, queries, cfg)
             for label, (c, queries, cfg, _k) in paths.items()}
    calls["fuzzy_int16"] = [
        ("colstream_fuzzy_i16", (a, dict(kw, int16_lanes=True)))
        for k, (a, kw) in calls["fuzzy"] if k == "colstream_fuzzy"]
    _drive("fuzzy_int16", calls["fuzzy_int16"], serving)
    paths_q = {label: p[1] for label, p in paths.items()}
    paths_q["fuzzy_int16"] = paths_q["fuzzy"]
    entries = []
    detail.setdefault("timing", {})
    for entry, name, source, replaces, paths in KERNELS:
        if entry == "lane_contract":
            continue  # its entry comes from the contract phase
        per_path = {p: [c for k, c in calls[p] if k == name] for p in paths}
        assert any(per_path.values()), f"{entry}: no launch captured"
        nums, work = _replay(entry, name, sum(per_path.values(), []), errs)
        if len(paths) > 1:
            work["per_path"] = {
                p: _replay(entry, name, c, errs)[0]
                for p, c in per_path.items() if c
            }
        work["per"] = "one batch of each of " + ", ".join(
            f"{p} (Q={len(paths_q[p])})" for p in paths)
        detail["timing"][entry] = {**nums, **work}
        print(f"timing phase: {entry} " + json.dumps(detail["timing"][entry]),
              flush=True)
        entries.append({
            "name": entry, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(serving[p]["launches"][name] for p in paths),
            "max_abs_err": errs[entry],
            **nums,
        })
    ab_phase(calls, detail)
    return entries


def contract_phase(dev, errs, detail):
    """The lane contract kernel on its own path: every launch counter set
    to 0, one launch over ``contract.contract_inputs``, the counters read;
    its outputs held bit-equal to ``contract.contract_plain`` (a mismatch
    names the outputs, rows and values that differ), then timed. Returns
    its ``kernels`` entry."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import contract as ct
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING

    ins = ct.contract_inputs(seed=1, device=dev)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    got = ct.lane_contract(*ins, DEFAULT_SCORING)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = ct.contract_plain(*ins, DEFAULT_SCORING)
    mism = {}
    for name, g, w, x in zip(("units", "pairs", "keys", "words", "rows"),
                             got, want, ins):
        bad = g != w
        if bad.any():
            rows = bad.reshape(bad.shape[0], -1).any(dim=1).nonzero()[:8, 0]
            mism[name] = {
                "count": int(bad.sum()),
                "columns": (bad.reshape(bad.shape[0], -1).any(dim=0)
                            .nonzero()[:, 0].tolist()),
                "inputs": x[rows].tolist(), "got": g[rows].tolist(),
                "want": w[rows].tolist()}
    detail["contract"] = {"launches": launches["lane_contract"],
                          "mismatches": mism,
                          "sizes": [int(t.shape[0]) for t in ins]}
    if mism:
        print("contract phase: MISMATCH " + json.dumps(mism), flush=True)
    _check_equal(errs, "lane_contract", got, want, "contract")
    assert launches["lane_contract"] == 1, launches
    nums, work = _replay("lane_contract", "lane_contract",
                         [(ins, dict(scoring=DEFAULT_SCORING))], errs)
    detail.setdefault("timing", {})["lane_contract"] = {**nums, **work}
    print(f"contract phase: lane_contract bit-equal to its plain model on "
          f"{detail['contract']['sizes'][:5]} units, byte pairs, keys, "
          f"s16x2 words and rows (int32 and int16 walks) "
          + json.dumps(nums), flush=True)
    return {"name": "lane_contract", "route": "cuda",
            "source": "frizbee_tpu_torch/csrc/lane_contract.cu",
            "replaces": "tests/test_kernel_contract.py:52",
            "launches": launches["lane_contract"],
            "max_abs_err": errs["lane_contract"], **nums}


def cpu_parity_phase(detail):
    """Reduced size: the card's serving arrays equal the CPU's, group by
    group, and so do the decoded top-k results — byte corpora, Arabic and
    Korean codepoint corpora, and ASCII needles under ALWAYS over a
    mixed-script codepoint corpus."""
    from frizbee_tpu_torch import Config, UnicodeMatching, datagen
    from frizbee_tpu_torch import match_topk_batch, pack_corpus
    from frizbee_tpu_torch.config import Scoring
    from frizbee_tpu_torch.matcher import Matcher, _dispatch_batch_groups

    n_rows, q = 20_000, 8
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=n_rows, seed=7)
    long_hay = _long_corpus(n_rows, seed=7)
    cases = [
        ("fuzzy T=0", hay, _queries(q), Config(max_typos=0)),
        ("fuzzy T=1", hay, _queries(q), Config(max_typos=1)),
        ("literal", hay, _literal_queries(q), Config()),
        (f"typo T={TYPO_BUDGET}", hay, _queries(q),
         Config(max_typos=TYPO_BUDGET)),
        ("long needle", long_hay, _queries(q, LONG_NEEDLE), Config()),
        (f"typo T={TYPO_BUDGET} wide scores", hay, _queries(q),
         Config(max_typos=TYPO_BUDGET, scoring=Scoring(**WIDE_SCORING))),
    ]
    # (label, rows, queries, config[, codepoint units, must match])
    for script in ("arabic", "korean"):
        rows = _unicode_corpus(n_rows, script, seed=7)
        cases += [
            (f"{script} fuzzy T=0", rows, _unicode_queries(q, script),
             Config(max_typos=0), True, True),
            (f"{script} fuzzy T=1", rows, _unicode_queries(q, script),
             Config(max_typos=1), True, True),
            (f"{script} literal", rows,
             _unicode_queries(q, script, "literal"), Config(), True, True),
            # Korean rows rarely hold 4 of 8 given syllables: the arrays
            # must still agree
            (f"{script} typo T={TYPO_BUDGET}", rows,
             _unicode_queries(q, script, 4), Config(max_typos=TYPO_BUDGET),
             True, script == "arabic"),
        ]
    mixed = _unicode_corpus(n_rows // 2, seed=8) + hay[:n_rows // 2]
    cases.append(("ALWAYS ascii needles, mixed script", mixed, _queries(q),
                  Config(unicode=UnicodeMatching.ALWAYS), True, True))
    packed = {}
    compared = {}
    for label, rows, queries, cfg, *uni in cases:
        unicode, must_match = uni or (False, True)
        key = id(rows)
        if key not in packed:
            packed[key] = (pack_corpus(rows, unicode=unicode),
                           pack_corpus(rows, unicode=unicode, device="cpu"))
        on_card, on_cpu = packed[key]
        raw = []
        for corpus in (on_card, on_cpu):
            ms = [Matcher.from_query(x, cfg) for x in queries]
            arrays = []
            for out, ready, members in _dispatch_batch_groups(
                    ms, corpus, cfg, TOP_K):
                if ready is not None:
                    ready.synchronize()
                arrays.append((out.numpy().copy(), members))
            raw.append(arrays)
        assert len(raw[0]) == len(raw[1])
        for (a, ma), (b, mb) in zip(*raw):
            assert ma == mb
            assert np.array_equal(a, b), (
                f"card and CPU serving arrays differ: {label}")
        got = match_topk_batch(queries, on_card, cfg, k=TOP_K)
        want = match_topk_batch(queries, on_cpu, cfg, k=TOP_K)
        for x, y in zip(got, want):
            assert x[0] == y[0]
            for u, v in zip(x[1:], y[1:]):
                assert np.array_equal(u, v)
        assert sum(x[0] for x in got) > 0 or not must_match, (
            f"{label}: nothing matched")
        compared[label] = sum(a.size for a, _m in raw[0])
    detail["cpu_parity_elements"] = compared
    print(f"card-vs-CPU phase: serving-array elements equal "
          f"({n_rows} rows, Q={q}): {json.dumps(compared)}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from frizbee_tpu_torch import datagen, pack_corpus
    from frizbee_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    detail = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    detail["build"] = {k: {"seconds": v["seconds"], "ptxas": v["log"]}
                       for k, v in built.items()}
    print(smi, flush=True)
    print(f"kernel build: {build_s:.1f} s ({len(built)} libraries, "
          f"nvcc in parallel)", flush=True)

    t0 = time.perf_counter()
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=N_ROWS)
    corpus = pack_corpus(hay)
    for b in corpus.buckets:
        b.device_arrays_colstream()
        b.device_presence_bits()
        b.device_arrays_ascii()
    torch.cuda.synchronize()
    detail["pack_seconds"] = time.perf_counter() - t0
    detail["buckets"] = [(b.width, b.size) for b in corpus.buckets]
    print(f"corpus: {len(corpus)} rows, buckets {detail['buckets']}, "
          f"generated and packed in {detail['pack_seconds']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    long_hay = _long_corpus(N_ROWS)
    long_corpus = pack_corpus(long_hay)
    for b in long_corpus.buckets:
        b.device_presence_bits()
        b.device_arrays_ascii()
    torch.cuda.synchronize()
    detail["long_pack_seconds"] = time.perf_counter() - t0
    detail["long_buckets"] = [(b.width, b.size) for b in long_corpus.buckets]
    print(f"long-needle corpus: {len(long_corpus)} rows, buckets "
          f"{detail['long_buckets']}, generated and packed in "
          f"{detail['long_pack_seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    uhay = _unicode_corpus(N_ROWS)
    detail["unicode_generate_seconds"] = time.perf_counter() - t0
    ucorpus = pack_corpus(uhay, unicode=True)
    for b in ucorpus.buckets:
        b.device_arrays_colstream()
        b.device_presence_bits()
        b.device_arrays_units()
    torch.cuda.synchronize()
    detail["unicode_pack_seconds"] = time.perf_counter() - t0
    detail["unicode_buckets"] = [(b.width, b.size) for b in ucorpus.buckets]
    print(f"unicode corpus (Arabic): {len(ucorpus)} rows, buckets "
          f"{detail['unicode_buckets']}, generated in "
          f"{detail['unicode_generate_seconds']:.1f} s, packed by "
          f"{detail['unicode_pack_seconds']:.1f} s", flush=True)

    phases = {}
    t0 = time.perf_counter()
    errs = kernel_phase(corpus, detail)
    phases["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unicode_kernel_phase(ucorpus, errs, detail)
    phases["kernel_unicode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    contract_entry = contract_phase(corpus.device, errs, detail)
    phases["contract"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = _paths(corpus, long_corpus, ucorpus)
    serving = serving_phase(paths, detail)
    phases["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = timing_phase(paths, serving, errs, detail)
    entries.append(contract_entry)
    phases["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_phase("fuzzy", corpus, _queries(Q), detail, host_profile=True)
    profile_phase("unicode_fuzzy", ucorpus, _unicode_queries(UQ), detail)
    phases["profile"] = time.perf_counter() - t0
    del corpus, hay, long_corpus, long_hay, ucorpus, uhay, paths
    t0 = time.perf_counter()
    cpu_parity_phase(detail)
    phases["cpu_parity"] = time.perf_counter() - t0
    detail["phase_seconds"] = phases
    detail["total_seconds"] = time.perf_counter() - t_start
    detail["kernels"] = entries

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_detail.json"), "w") as fh:
        json.dump(detail, fh, indent=1)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
