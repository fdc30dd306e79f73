"""Smoke run of frizbee_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``frizbee_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and its native host library and
extension from ``frizbee_tpu_torch/native`` (printing the compilers, the
build seconds and the OpenMP thread count), then runs the phases below.
Three pieces of work run beside them, each in a process of its own on
the same card (``_Side``), and are joined before any phase that times
the card or the host: the Arabic corpus's generation (beside the builds,
the byte corpora and the ASCII kernel phase), the kernel phase's checks at the template, tile
and pairing boundaries (beside the rest of the kernel phase), and the
card-versus-CPU phase 7 (beside phase 1). The phases:

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
   tile boundary, and at the pairing boundaries that
   ``frizbee_tpu_torch/ops/pairing.py`` builds (pass-2 queues of every
   length mod 4, a full doubled queue, a 1-column window paired with a
   W-column one, matched rows all in one half of a tile's length order,
   an empty row beside a full one, a matched half beside a rejected
   one); the lane contract kernel against its plain model at 40 rows
   (the timed launch) and at 1, 33 and 97 rows, then timed beside an
   empty kernel on its grid (its launch floor); the
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
   (row-major), the same under a scoring whose cells exceed int16
   (row-major), and 24-byte needles over a second 1M-row partial-match
   corpus of that needle (row-major); the typo and long-needle batches
   take the int16-lane instantiation alone and the wide-scoring one the
   int32 instantiation alone (``kernels.INT16_CUDA_OK`` is set), asserted
   through the launch counters;
   each finalizes through the row gather; then three unicode batches of Q=16 over the 1M-row Arabic
   corpus, recording their finalize routes: the 16 two-letter variants
   of "إن" (colstream fuzzy), the same under ', ^, $ and ^...$ (colstream
   literal), and 16 eight-codepoint needles at max_typos=4 (row-major);
   then the multi-pattern paths, whose colstream launches run in
   columns mode and combine on the device: ``multi`` (Q=32 over the 1M
   partial-match rows, four shape groups of 8 — two fuzzy halves of a
   permutation, a permutation with a negated 3-byte substring, a 2-byte
   prefix with the 6-byte fuzzy rest, a 3-byte substring with a negated
   prefix) and ``unicode_multi`` (Q=16 over the Arabic corpus, "إن X"
   and "إن !Y", a negated substring), each asserting that colstream
   fuzzy and literal launched and every group took the multi flow;
3. single phase: the single-query Matcher API at Q=1 on the 1M-row
   corpora, ``Matcher(q).match_arrays`` over the tiered result window
   (max(65,536, N/8) rows, the count and the first 8,192 rows copied
   back): "deadbeef" (colstream fuzzy, key-emit), "^dead" (colstream
   literal), "deadbeef" at max_typos=4 and the 24-byte needle over its
   corpus (row-major, int16 lanes), "dead !^beef" (columns mode), the
   broad needle "e" (its count passes the tier: the full-window
   re-dispatch and the full-sort finalize, asserted), and over the Arabic
   corpus "إن" and an eight-codepoint needle at max_typos=4; the ASCII
   and Arabic calls are paths of their own (``single``,
   ``single_unicode``), counters set to 0 just before and read just
   after; each query's kernels asserted, its rows held to
   ``match_topk_batch``'s top 2048, its first call (new Matcher, cold
   dispatch cache) and the median of 20 cached calls timed; "deadbeef"
   and the broad needle's whole results held equal to the port on a
   CPU-packed copy of the corpus;
   indices phase: ``Matcher(q).match_list_indices`` for the same queries
   over the same corpora (the match set from ``match_arrays`` on the
   card, the traceback on the host: the batched native walk for a single
   fuzzy needle with at least 32 matches, else the per-row oracle),
   paths of their own (``indices``, ``indices_unicode``) whose launches
   join the kernels line's counts; each query's kernels asserted, its
   entries in ``match_arrays``' order with its scores and exact flags,
   2,000 entries (the first and last 500) equal to the per-row oracle,
   the first call and a cached call timed with the share inside
   ``match_arrays``, the host memory of a call, one more cached call
   through the NumPy walk equal to the native one and timed beside it;
   and ``match_iter_indices`` over the Corpus for "deadbeef", equal to
   the list in input order;
   native phase: the native host components at 1M rows, each equal to
   its NumPy or per-row twin (``native._FORCE_NUMPY``) and timed beside
   it: the packer over the ASCII and Arabic rows, and the host fixups
   of fuzzy T=0/T=1 and multi batches (Q=32) over the 1M rows plus XL
   rows, and of fuzzy and multi batches (Q=16) over the Arabic rows
   plus greedy rows;
   parallel phase: mesh-sharded serving (``frizbee_tpu_torch/parallel.py``)
   on the card, each result equal to single-device serving:
   ``match_topk_batch_sharded`` on ``make_mesh(1)`` and on four shards of
   the one card for the fuzzy batch (Q=32), a full-syntax batch (Q=8),
   the four sort strategies (Q=2) and the Arabic fuzzy batch (Q=16),
   each timed beside single-device; ``match_corpus_sharded`` at 4 shards
   (fuzzy T=0, T=1); greedy and XL rows over a 20k-row codepoint corpus;
   a world of one over NCCL; two gloo ranks in subprocesses on the card
   over a 100k-row corpus (paths ``parallel`` and ``parallel_unicode``,
   whose ``match_units`` launches join the kernels line; the 4-shard
   fuzzy, full-syntax, Arabic and greedy/XL batches' launches are
   captured in that run for the timing phase);
4. timing phase: the launches of one more batch of each path, captured
   (``_build.CAPTURE``) and replayed per kernel — held bit-equal to its
   plain version on the same arguments, then timed (CUDA events, warmed
   up, queued behind a device sleep so host launch overhead leaves no
   gaps) beside the bound this run's data needs, its plain version and,
   for the row gather (ASCII and unicode paths apart, and per path),
   ``torch.index_select`` (a kernel of several paths has its plain
   version run once a launch, per path, and its plain time summed); the fuzzy batch's colstream launches driven
   once more with ``int16_lanes=True`` and the typo and long-needle
   batches' row-major launches with int32 lanes (paths of their own);
   and, on the same captured launches in 10 alternating rounds,
   the int16 and int32 instantiations of ``match_units`` (typo, long
   needle) and of the colstream fuzzy kernel (fuzzy): medians, the share
   of rounds the int16 one won, and the bound both share;
5. probes phase: the reference's kernel probes
   (``frizbee_tpu_torch/probes/``) at its shapes, each a path of its own
   with the counters set to 0 just before and read just after, each of
   their checks asserted: the broad top-k tournament at R 64 and 128
   against the full sort and ``torch.topk``, with the gather alone; the
   transposed recurrence's check (K-linearity) and its comparison with
   ``match_units``; the ten colstream bisect stages and the whole
   colstream kernel at 2048 rows, then timed at 1M rows. Each probe
   kernel is then held bit-equal to its plain version on that probe's
   inputs and timed beside its bound and plain version (the row gather
   beside ``torch.index_select``), and at the shapes the ring design
   makes risky (``_probe_edge_checks``); then the ring designs of the
   transposed and bisect kernels against their first designs (the ``v1``
   C entry points) on the probes' own timed launches, in AB_ROUNDS
   alternating rounds (``probe_ab_phase``), with the ptxas report and
   the static SASS opcode mix of both designs;
6. profile phase: ``torch.profiler`` over blocking fuzzy batches, ASCII
   and unicode, and multi-pattern ones, each call inside
   ``profiling.annotate`` (the span asserted among the events; wall
   time, device busy time, top kernels and host operations; the fuzzy
   batch's through ``profiling.trace``, its Chrome trace kept in
   ``chiprun_out/traces/``) and cProfile
   over one ASCII batch; and over cached single-query calls of
   "deadbeef" and the broad needle;
7. card-versus-CPU phase (beside phase 1, with SIDE_CPU_THREADS torch
   threads): at 20k rows, Q=8, the (Q, 1+k, 2) serving
   arrays and the decoded top-k on the card equal the CPU's for fuzzy
   T=0 and T=1, literal, T=4 and long-needle batches, the multi-pattern
   groups at T=0 and T=1 with an all-negated query, for Arabic and
   Korean codepoint corpora (fuzzy T=0, T=1, literal, T=4) and the Arabic
   multi-pattern groups, for ASCII needles under UnicodeMatching.ALWAYS
   over a mixed-script corpus, for the rows plus 64 XL rows (fuzzy T=0
   and T=1, literal, multi; the host fixups must add XL rows), and for
   the Arabic rows plus 32 rows of 600-1000 codepoints (fuzzy and multi;
   greedy-flagged rows must come back and are rescored on the host);
   then the single-query API at 20k rows: ``match_list``,
   ``match_list_parallel(shards=4)``, ``match_arrays_batch`` at Q=32, the
   empty query, an ASCII needle over an Arabic-packed corpus (the
   repack), a greedy-risk corpus past k through ``match_topk_batch`` (the
   full-fetch fallback), ``match_iter`` over 262,144 strings in
   chunks of 65,536, and ``match_list_indices`` of every single-phase
   query, each equal to the port on the CPU; and device memory
   back at its level before a pack once the corpus a Matcher's dispatch
   cache held is dropped.

A watchdog (``_Watchdog``) gives every phase, side process and the late
build thread a budget (PHASE_BUDGETS, SIDE_TIMEOUT, LATE_BUILD_BUDGET):
at WATCH_SHARE of it, it prints every thread's Python stack and the
tasks' /proc states (a side process prints its own into its log); at the
whole budget it prints them again, kills the side processes and ends the
run with exit code 1.

Prints the card's name and power limit first, one JSON ``kernels`` line
before the last, and ``{"ok": true, "device": {...}}`` last. Exits
non-zero, printing no result, when there is no CUDA device or any phase
fails or overruns its budget. Details (per-phase seconds, ptxas reports) go to
``chiprun_out/chip_smoke_detail.json``.
"""

import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import threading
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

# H100 SXM peaks: device memory rate (NVIDIA data sheet), and the rate
# at which the card can issue instructions = 4 schedulers per SM x 32
# lanes (one warp instruction each a clock) x 132 SMs x 1.98 GHz. The
# kernels' operations are mixed integer instructions that the card
# spreads over its ALU and FMA pipes (64 lanes an SM each for int32), so
# no one pipe's rate bounds them, but every instruction takes an issue
# slot
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 128 * 132 * 1.98e9
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
# the probe kernels: the fewest int32 instructions their C expressions
# need for what reaches an output (a compare may fold one predicate in, a
# predicated add replaces a select, a DPX add-max-relu is one; loads are
# counted as bytes). The transposed recurrence, per cell: the compare,
# the miss's relu(diag_in - 6), the match's predicated +12, cur as one
# add-max over prev - 1 and diag, and half a 3-input max (VIMNMX3) into
# best (the reference's srow/left never reaches its output and is not run)
TRANSPOSED_OPS_PER_CELL = 4.5
# the bisect stages: (per needle-unit cell, per column) of a row's walk
# over all W columns. A: the cell as the transposed one less the best
# (the valid test folded into the compare), per column the valid test and
# the best max. B: per cell the orig and flip tests under the window (3),
# the diagonal with its hoisted bonus and the exact bonus (3), the up
# move's mismatch cost and add-max (2), the left move's match-bit test,
# cost and add-max (3), the match bit (1); per column the window and
# first-unit tests, the byte classes of the unit and the previous one,
# the bonus, the exact test, the last unit's end column and the carries
# (39). C and C2: per cell the chain's position test under valid, the two
# unit compares and the or into the advance (4); per column the start and
# tail tracking with the carries (14), C2 only the advance and the count
# (4). C1: per cell two compares or-ed into the hit (2). The bisect2
# stages advance on the first unit's hit alone, so only units 0 and n-1
# reach an output: both_outcarries tracks start and tail (22 a column);
# the other four write zeros or carries never set, leaving the first
# unit's test, the advance and the count (7).
BISECT_OPS = {
    "a_simple+outs": (4, 2),
    "b_full_sw": (12, 39),
    "c_pf_t0": (4, 14),
    "c1_no_advance": (2, 14),
    "c2_only_advance": (4, 4),
    "fstart_only_outz": (0, 7),
    "tail_only_outz": (0, 7),
    "both_outz": (0, 7),
    "none_outcarries": (0, 7),
    "both_outcarries": (0, 22),
}
# the 1M-row fuzzy shape the bisect stages are timed at (1024 groups)
PROBE_BISECT_ROWS = 1 << 20

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
# a user scoring whose cells exceed int16 at the typo batch's needles
# (8 x 4008 + 20 > 30000): the reference serves it in int32 lanes, so the
# row-major kernel's int32 byte instantiation keeps a serving path
WIDE_SCORING = dict(match_score=4000)
# rounds of the int16-against-int32 A/B on the captured launches
AB_ROUNDS = 10
# the kernel library that builds while the phases before the probes run
LATE_BUILD = "probe_colstream_bisect"


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


def _multi_queries(q):
    """Multi-pattern and negated queries, four shape groups of q // 4
    built from the bench permutations: two fuzzy atoms, the 4-byte halves
    of a permutation ("dead beef"); a fuzzy permutation and a negated
    3-byte substring of a "cafebabe" permutation ("deadbeef !'caf"); a
    2-byte prefix and the 6-byte fuzzy rest ("^de adbeef"); a 3-byte
    substring and a negated 3-byte prefix (the "'foo !^bar" shape)."""
    g = q // 4
    perms = _queries(g)
    other = _queries(g, "cafebabe")
    return ([p[:4] + " " + p[4:] for p in perms]
            + [p + " !'" + o[:3] for p, o in zip(perms, other)]
            + ["^" + p[:2] + " " + p[2:] for p in perms]
            + ["'" + p[:3] + " !^" + p[3:6] for p in perms])


def _unicode_multi_queries(q, script="arabic"):
    """Two shape groups of q // 2 (the reference's unicode multi-pattern
    set): the script's needle and another variant, both fuzzy ("إن X"),
    and the needle with another variant negated ("إن !Y", a bare negated
    atom matches substrings)."""
    base = UNICODE_VARIANTS[script]
    head, rest = base[0], base[1:]
    g = q // 2
    return ([f"{head} {rest[i % len(rest)]}" for i in range(g)]
            + [f"{head} !{rest[(i + 7) % len(rest)]}" for i in range(g)])


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


def kernel_phase(corpus, detail, boundaries):
    """Each kernel against its plain version on the card, bit-equal. The
    checks at the template, tile and pairing boundaries run beside this in
    a process of their own (``_side_kernel_boundaries``); ``boundaries()``
    joins it and returns its counts."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    nq = torch.from_numpy(_needles(_queries(Q))).to(dev)
    errs = {entry[0]: 0.0 for entry in KERNELS}
    checks = 0
    seconds = {}
    t0 = time.perf_counter()
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
    seconds["colstream_fuzzy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather_shapes = _gather_shapes(corpus)
    rg = _row_gather_checks(dev, errs, gather_shapes)
    seconds["row_gather"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lit = _literal_kernel_checks(corpus, errs)
    seconds["colstream_literal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rm = _rowmajor_kernel_checks(corpus, errs)
    seconds["match_units"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    side = boundaries()
    seconds["boundaries_wait"] = time.perf_counter() - t0
    detail["kernel_phase_seconds"] = seconds
    for name, err in side.pop("errs").items():
        errs[name] = max(errs.get(name, 0.0), err)
    rmx, tbx, px = (side["checks"][k] for k in BOUNDARY_CHECKS)
    checks += rg + lit + rm + rmx + tbx + px
    detail["kernel_checks"] = checks
    detail["kernel_boundary_checks"] = side
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
          f"pairing boundaries (ops/pairing); row_gather {rg}: C "
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
    """The int16-lane kernels at their pairing boundaries, on the inputs
    ``ops/pairing`` builds (which the CPU tests hold to the reference).
    Row-major: its 640-row bucket (all-matched, all-rejected and mixed
    rows; empty, full, 1- and 128-unit rows) at (n, T)
    ``pairing.ROWMAJOR_NT`` (the greedy embedding and the DP), the two
    queries at live counts ``pairing.ROWMAJOR_COUNTS`` (queues of every
    length mod 4, a warp, the int32 and the doubled block crossed, a
    1-unit row paired with a 128-unit one), both modes. Colstream: its
    five-group bucket (an empty row beside a full one, a matched row
    beside a rejected one, tiles of 1, 2, 3, 5, 7, 65, 127 and 128
    matched rows, matched rows all in one half of the length order, a
    1-column window beside a 32-column one) at (n, T)
    ``pairing.COLSTREAM_NT``, three queries at live counts
    ``pairing.COLSTREAM_COUNTS``, both modes. Returns the number of
    checks."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km
    from frizbee_tpu_torch.ops import pairing as pc

    checks = 0
    for n, T in pc.ROWMAJOR_NT:
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in pc.rowmajor_case(pc.SEED, n, T).items()}
        nq = torch.stack([c["needle"], c["needle"]])
        for counts in pc.ROWMAJOR_COUNTS:
            kw = dict(n=n, max_typos=T, scoring=km.DEFAULT_SCORING,
                      idx_bits=10, int16_lanes=True)
            checks += _rowmajor_pair_check(
                errs, c["cp"], c["nu"], nq, c["idx"], c["rows"], counts, kw,
                f"pairing n={n} T={T} counts={counts}")

    c = {k: torch.from_numpy(v).to(dev)
         for k, v in pc.colstream_case(pc.SEED).items()}
    for n, T in pc.COLSTREAM_NT:
        nq = torch.from_numpy(_needles(pc.COLSTREAM_QUERIES[n])).to(dev)
        for counts in pc.COLSTREAM_COUNTS:
            scal = km.pack_needle_scalars(nq, 0)
            scal[:, 0] = torch.tensor(counts)
            kw = dict(W=pc.COLSTREAM_W, n=n, max_typos=T,
                      scoring=km.DEFAULT_SCORING, idx_bits=13,
                      int16_lanes=True)
            for ix in (c["idxT"], None):
                got = cs.match_units_colstream(c["cpT"], c["nuT"], scal, None,
                                               ix, **kw)
                torch.cuda.synchronize()
                want = cs.match_units_colstream_plain(c["cpT"], c["nuT"],
                                                      scal, None, ix, **kw)
                _check_equal(errs, "colstream_fuzzy_i16", got, want,
                             f"pairing n={n} T={T} counts={counts} "
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


def _counters():
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import batch as fb

    return (_build.LAUNCHES, fb.FINALIZE_ROUTES, fb.ROW_MAJOR_ROUTES,
            fb.COLSTREAM_FLOWS, fb.GENERIC_ROUTES)


def _reset_counters():
    for counter in _counters():
        for k in counter:
            counter[k] = 0


def _serve(label, corpus, queries, cfg, kernels, detail):
    """One serving path: match_topk_batch (warm-up, 3 blocking batches)
    and a depth-3 match_topk_batch_async pipeline, with every launch and
    route counter set to 0 just before and read just after; fails unless
    each kernel of ``kernels`` launched."""
    from frizbee_tpu_torch import match_topk_batch, match_topk_batch_async
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import batch as fb

    _reset_counters()
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
    colstream_flows = dict(fb.COLSTREAM_FLOWS)
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
        "colstream_flows": colstream_flows,
        "peak_device_memory_bytes": peak,
        "match_counts": [int(r[0]) for r in res],
    }
    detail.setdefault("serving", {})[label] = out
    print(f"serving phase, {label}: " + json.dumps(
        {k: v for k, v in out.items() if k != "match_counts"}), flush=True)
    return out


def _paths(corpus, long_corpus, ucorpus):
    """The ten serving paths: label -> (corpus, queries, config, the
    kernels the path must launch). The multi-pattern batches launch the
    colstream kernels in columns mode. The typo and long-needle batches take
    the int16-lane instantiation of the row-major kernel (their rows fit
    int16 lanes and ``kernels.INT16_CUDA_OK`` is set), the wide-scoring
    typo batch and the unicode one the int32 instantiation. The unicode
    batches record
    their finalize route without requiring one: most Arabic groups stay
    alive for any needle, so the capped route and its row gather may not
    run."""
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
        "multi": (corpus, _multi_queries(Q), Config(),
                  ("colstream_fuzzy", "colstream_literal")),
        "unicode_multi": (ucorpus, _unicode_multi_queries(UQ), Config(),
                          ("colstream_fuzzy", "colstream_literal")),
    }


def serving_phase(paths, detail):
    """The ten serving paths, each read on its own."""
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
    # the typo and long-needle batches went through the int16-lane
    # instantiation alone (the reference's predicate, the card's gate
    # open), the wide-scoring one through the int32 instantiation alone,
    # with the same matches as the typo batch
    for label, lanes in (("typo", "match_units_i16"),
                         ("long_needle", "match_units_i16"),
                         ("typo_wide", "match_units")):
        launched = serving[label]["launches"]
        other = ({"match_units", "match_units_i16"} - {lanes}).pop()
        assert launched[lanes] > 0 and launched[other] == 0, (label,
                                                              launched)
    assert serving["typo_wide"]["match_counts"] == typo["match_counts"]
    assert serving["long_needle"]["match_counts"][0] > 0, (
        "no match for the long needle")
    ufuzzy, utypo = serving["unicode_fuzzy"], serving["unicode_typo"]
    assert ufuzzy["match_counts"][0] > 0, "no match for the unicode needle"
    assert sum(serving["unicode_literal"]["match_counts"]) > 0, (
        "no unicode literal query matched")
    assert utypo["row_major_routes"]["compacted"] == utypo["batches"]
    assert utypo["match_counts"][0] > 0, "no unicode typo-budget match"
    # the multi-pattern batches: every shape group through the multi flow
    # (4 groups, 2 unicode), none through the single-pattern flows
    for label, groups in (("multi", 4), ("unicode_multi", 2)):
        out = serving[label]
        assert out["colstream_flows"] == {
            "single": 0, "multi": groups * out["batches"]}, (
            label, out["colstream_flows"])
        assert min(out["match_counts"]) >= 0
        counts = out["match_counts"]
        g = len(counts) // groups
        assert all(sum(counts[i * g:(i + 1) * g]) > 0
                   for i in range(groups)), (label, counts)
    return serving


# the single-query Matcher path at Q=1 (label, corpus, query, config
# keywords, kernels its first call must launch): the column-stream
# kernels in key-emit mode and, for the multi query, columns mode; the
# row-major kernel in int16 lanes on byte rows, int32 on codepoints; a
# broad one-byte needle whose count passes the 131,072-row tier, so the
# full-window re-dispatch and the full-sort finalize run
SINGLE_QUERIES = (
    ("fuzzy", "ascii", "deadbeef", {}, ("colstream_fuzzy", "row_gather")),
    ("literal", "ascii", "^dead", {}, ("colstream_literal",)),
    ("typo", "ascii", "deadbeef", {"max_typos": TYPO_BUDGET},
     ("match_units_i16",)),
    ("long_needle", "long", LONG_NEEDLE, {}, ("match_units_i16",)),
    ("multi", "ascii", "dead !^beef", {},
     ("colstream_fuzzy", "colstream_literal")),
    ("broad", "ascii", "e", {}, ("colstream_fuzzy",)),
    ("unicode_fuzzy", "arabic", UNICODE_NEEDLE["arabic"], {},
     ("colstream_fuzzy",)),
    ("unicode_typo", "arabic", _unicode_queries(1, kind=TYPO_BUDGET)[0],
     {"max_typos": TYPO_BUDGET}, ("match_units",)),
)
# the single paths' counters: ASCII and codepoint launches apart, as the
# kernels line keeps them
SINGLE_PATHS = ("single", "single_unicode")
SINGLE_TIMED_CALLS = 20


def _single_queries(corpora):
    """(label, path, corpus, query, Config, kernels) of SINGLE_QUERIES."""
    from frizbee_tpu_torch import Config

    return [(label, SINGLE_PATHS[key == "arabic"], corpora[key], q,
             Config(**cfg), kernels)
            for label, key, q, cfg, kernels in SINGLE_QUERIES]


def single_phase(corpora, hay, serving, detail):
    """The single-query Matcher API at Q=1 on the 1M-row corpora, through
    ``Matcher(q).match_arrays``: each path (ASCII, Arabic) with every
    counter set to 0 just before its first calls and read just after;
    each query's launches and finalize routes, asserting the kernels it
    must launch; its decoded rows against ``match_topk_batch``'s top
    2048; the first call (a new Matcher: cold dispatch cache) and the
    median of SINGLE_TIMED_CALLS cached calls, blocking ms; the broad
    needle's count past the tier and its full-window re-dispatch; and
    card against CPU at 1M rows for "deadbeef" and the broad needle."""
    from frizbee_tpu_torch import Matcher, match_topk_batch, pack_corpus
    from frizbee_tpu_torch import matcher as fm
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import batch as fb

    queries = _single_queries(corpora)
    out = {}
    results = {}
    dispatches = []
    dispatch = fm.Matcher._fused_dispatch

    def counting_dispatch(self, corpus, full_window=False, prep=None):
        dispatches.append(bool(full_window))
        return dispatch(self, corpus, full_window, prep)

    fm.Matcher._fused_dispatch = counting_dispatch
    try:
        for path in SINGLE_PATHS:
            mine = [x for x in queries if x[1] == path]
            _reset_counters()
            torch.cuda.synchronize()
            for label, _p, corpus, q, cfg, kernels in mine:
                before = [dict(c) for c in _counters()]
                dispatches.clear()
                t0 = time.perf_counter()
                res = Matcher.from_query(q, cfg).match_arrays(corpus)
                cold_ms = (time.perf_counter() - t0) * 1e3
                launched, routes = (
                    {k: v - b.get(k, 0) for k, v in c.items()
                     if v - b.get(k, 0)}
                    for c, b in zip(_counters()[:2], before[:2]))
                for name in kernels:
                    assert launched.get(name, 0) > 0, (
                        f"single {label}: kernel {name} never launched")
                results[label] = res
                out[label] = {
                    "query": q, "corpus_rows": len(corpus),
                    "max_typos": cfg.max_typos, "count": len(res[0]),
                    "launches": launched, "finalize_routes": routes,
                    "dispatches": ["full" if f else "tier"
                                   for f in dispatches],
                    "cold_ms": cold_ms,
                }
            torch.cuda.synchronize()
            serving[path] = {"launches": dict(_build.LAUNCHES),
                             "finalize_routes": dict(fb.FINALIZE_ROUTES)}
    finally:
        fm.Matcher._fused_dispatch = dispatch
    tier = max(fm.Q1_WINDOW_MIN, N_ROWS // 8)
    broad = out["broad"]
    assert broad["count"] > tier, (
        f"the broad needle's {broad['count']} matches fit the "
        f"{tier}-row tier")
    assert broad["dispatches"] == ["tier", "full"], broad["dispatches"]
    assert broad["finalize_routes"].get("full", 0) > 0, broad
    for label, _p, corpus, q, cfg, _k in queries:
        res = results[label]
        assert np.all(np.diff(res[1]) <= 0), f"single {label}: not sorted"
        assert len(res[0]) > 0, f"single {label}: nothing matched"
        top = match_topk_batch([q], corpus, cfg, k=TOP_K)[0]
        assert top[0] == len(res[0]), (label, top[0], len(res[0]))
        for a, b in zip(top[1:], res):
            assert np.array_equal(a, b[:TOP_K]), (
                f"single {label}: rows differ from match_topk_batch")
        m = Matcher.from_query(q, cfg)
        m.match_arrays(corpus)
        times = []
        for _ in range(SINGLE_TIMED_CALLS):
            t0 = time.perf_counter()
            m.match_arrays(corpus)
            times.append((time.perf_counter() - t0) * 1e3)
        out[label]["cached_ms"] = times
        out[label]["cached_median_ms"] = float(np.median(times))
        print(f"single phase, {label}: " + json.dumps(
            {k: v for k, v in out[label].items() if k != "cached_ms"},
            ensure_ascii=False), flush=True)
    # card against CPU at 1M rows: the whole result, plain versions on a
    # CPU-packed copy of the corpus
    t0 = time.perf_counter()
    on_cpu = pack_corpus(hay, device="cpu")
    for label, _p, _c, q, cfg, _k in queries:
        if label not in ("fuzzy", "broad"):
            continue
        want = Matcher.from_query(q, cfg).match_arrays(on_cpu)
        for a, b in zip(results[label], want):
            assert np.array_equal(a, b), f"single {label}: card != CPU"
    del on_cpu
    detail["single_cpu_parity_seconds"] = time.perf_counter() - t0
    detail["single"] = out
    return [(path, [(x[2], x[3], x[4]) for x in queries if x[1] == path])
            for path in SINGLE_PATHS], results


def _capture_single(calls_of):
    """The launches (kernel name, (args, kwargs)) of one cached
    ``match_arrays`` call of each query of a single path."""
    from frizbee_tpu_torch import Matcher
    from frizbee_tpu_torch.ops import _build

    _build.CAPTURE = []
    for corpus, q, cfg in calls_of:
        Matcher.from_query(q, cfg).match_arrays(corpus)
    calls, _build.CAPTURE = _build.CAPTURE, None
    return calls


# the indices phase: Matcher(q).match_list_indices over the 1M-row corpora
# for every SINGLE_QUERIES query, a path of its own for each single path
# (counters set to 0 just before, read just after); per query the first
# call of a new Matcher and the median of INDICES_TIMED_CALLS cached ones,
# INDICES_ORACLE_ENTRIES entries (the first and last 500 among them) held
# to the per-row oracle, and the host memory of a call
INDICES_PATHS = {"single": "indices", "single_unicode": "indices_unicode"}
# cached calls a query takes with the native fill and walk; one more takes
# the NumPy walk (traceback._FORCE_NUMPY) where the query walks at all
INDICES_TIMED_CALLS = 1
INDICES_ORACLE_ENTRIES = 2000
INDICES_ORACLE_ENDS = 500


class _RssPeak:
    """Resident set size of this process over a block: ``resource``'s
    lifetime high-water mark before and after, and the peak above the
    block's start sampled every 2 ms from /proc/self/statm (the
    high-water mark only moves past the earlier phases' peak)."""

    def __enter__(self):
        import resource
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.maxrss_before = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        self.start = self._rss()
        self.peak = self.start
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        self.maxrss_after = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        return False

    def record(self):
        return {"rss_start_bytes": self.start,
                "rss_peak_above_start_bytes": self.peak - self.start,
                "ru_maxrss_before_bytes": self.maxrss_before,
                "ru_maxrss_after_bytes": self.maxrss_after}


def _indices_rows(ms):
    return [(m.score, m.index, m.exact, list(m.indices)) for m in ms]


def indices_phase(corpora, single_results, serving, detail):
    """Matched-character indices at 1M rows: ``Matcher(q).match_list_indices``
    over the resident corpora for every SINGLE_QUERIES query. The match
    set comes from ``match_arrays`` on the card; the traceback runs on the
    host (the batched native walk for one fuzzy pattern with at least 32
    matches, else the per-row oracle). Per query: the kernels its first
    call must launch; the first call of a new Matcher and the median of
    INDICES_TIMED_CALLS cached calls (host clock), each split into the
    time inside ``match_arrays`` and the rest (the host traceback); one
    more cached call through the NumPy walk (``traceback._FORCE_NUMPY``)
    where the query walks, equal to the native one and timed beside it; its
    entries in the order and with the score and exact flag of the
    ``single`` phase's ``match_arrays`` rows; INDICES_ORACLE_ENTRIES
    entries, the first and last INDICES_ORACLE_ENDS among them, equal to
    the per-row ``match_one_indices`` oracle; the host memory of the last
    cached call (``_RssPeak``). Then ``match_iter_indices`` over
    the 1M-row Corpus for "deadbeef", equal to its list in input
    order."""
    from frizbee_tpu_torch import Matcher
    from frizbee_tpu_torch import matcher as fm
    from frizbee_tpu_torch import traceback as tb
    from frizbee_tpu_torch.ops import _build

    queries = _single_queries(corpora)
    out = {}
    spent = []
    walked = []
    match_arrays = fm.Matcher.match_arrays
    batched = tb.batched_match_indices

    def timed_match_arrays(self, haystacks):
        t0 = time.perf_counter()
        try:
            return match_arrays(self, haystacks)
        finally:
            spent.append(time.perf_counter() - t0)

    def counting_batched(engine, rows):
        walked.append(len(rows))
        return batched(engine, rows)

    def call(m, corpus):
        spent.clear()
        t0 = time.perf_counter()
        res = m.match_list_indices(corpus)
        total = (time.perf_counter() - t0) * 1e3
        arrays = sum(spent) * 1e3
        return res, total, arrays

    rng = np.random.default_rng(11)
    fm.Matcher.match_arrays = timed_match_arrays
    tb.batched_match_indices = counting_batched
    try:
        for path in SINGLE_PATHS:
            mine = [x for x in queries if x[1] == path]
            _reset_counters()
            torch.cuda.synchronize()
            for label, _p, corpus, q, cfg, kernels in mine:
                before = dict(_build.LAUNCHES)
                walked.clear()
                fresh = Matcher.from_query(q, cfg)
                res, cold_ms, cold_arrays_ms = call(fresh, corpus)
                cold_walk = list(walked)
                single_fuzzy = (len(fresh._compiled) == 1
                                and not fresh._compiled[0].negated
                                and fresh._compiled[0].config
                                .matching.is_fuzzy)
                assert cold_walk == ([len(res)] if single_fuzzy
                                     and len(res) >= 32 else []), (
                    f"indices {label}: batched walk over {cold_walk} rows")
                launched = {k: v - before.get(k, 0)
                            for k, v in _build.LAUNCHES.items()
                            if v - before.get(k, 0)}
                for name in kernels:
                    assert launched.get(name, 0) > 0, (
                        f"indices {label}: kernel {name} never launched")
                index, score, exact, _ec = single_results[label]
                got = [m.index for m in res]
                assert got == index.tolist(), (
                    f"indices {label}: entries differ from match_arrays")
                assert [m.score for m in res] == score.tolist(), label
                assert [m.exact for m in res] == exact.tolist(), label
                n = len(res)
                ends = min(INDICES_ORACLE_ENDS, n)
                pick = set(range(ends)) | set(range(n - ends, n))
                rest = np.setdiff1d(np.arange(n), sorted(pick))
                extra = max(INDICES_ORACLE_ENTRIES - len(pick), 0)
                pick |= set(rng.choice(rest, size=min(extra, rest.size),
                                       replace=False).tolist())
                oracle = Matcher.from_query(q, cfg)
                hay = corpus.haystacks
                t0 = time.perf_counter()
                for j in sorted(pick):
                    e = res[j]
                    want = oracle.match_one_indices(hay[e.index], e.index)
                    assert want is not None and _indices_rows(
                        [e]) == _indices_rows([want]), (
                        f"indices {label}: entry {j} (row {e.index}) "
                        f"differs from the per-row oracle")
                oracle_s = time.perf_counter() - t0
                cached = [call(fresh, corpus)[1:]
                          for _ in range(INDICES_TIMED_CALLS - 1)]
                with _RssPeak() as rss:
                    cached.append(call(fresh, corpus)[1:])
                numpy_walk = None
                if cold_walk:
                    # the same cached call through the NumPy fill and walk
                    # (the native walk's twin) must give the same entries
                    tb._FORCE_NUMPY = True
                    try:
                        twin, twin_ms, twin_arrays_ms = call(fresh, corpus)
                    finally:
                        tb._FORCE_NUMPY = False
                    assert _indices_rows(twin) == _indices_rows(res), (
                        f"indices {label}: the NumPy walk differs from "
                        f"the native walk")
                    del twin
                    numpy_walk = {"ms": twin_ms,
                                  "match_arrays_ms": twin_arrays_ms,
                                  "ms_a_row": (twin_ms - twin_arrays_ms)
                                  / max(n, 1)}
                totals = [t for t, _a in cached]
                arrays = [a for _t, a in cached]
                med = float(np.median(totals))
                med_arrays = float(np.median(arrays))
                out[label] = {
                    "query": q, "corpus_rows": len(corpus),
                    "max_typos": cfg.max_typos, "count": n,
                    "batched_walk_rows": cold_walk,
                    "launches": launched,
                    "cold_ms": cold_ms,
                    "cold_match_arrays_ms": cold_arrays_ms,
                    "cold_traceback_share": 1 - cold_arrays_ms / cold_ms,
                    "cached_ms": totals,
                    "cached_match_arrays_ms": arrays,
                    "cached_median_ms": med,
                    "cached_median_match_arrays_ms": med_arrays,
                    "cached_traceback_share": float(np.median(
                        [1 - a / t for t, a in cached])),
                    "native_walk_ms_a_row": (med - med_arrays) / max(n, 1),
                    "numpy_walk": numpy_walk,
                    "oracle_entries": len(pick),
                    "oracle_seconds": oracle_s,
                    "host_memory": rss.record(),
                }
                if label == "fuzzy":
                    fuzzy_rows = _indices_rows(res)
                del res
                print(f"indices phase, {label}: " + json.dumps(
                    {k: v for k, v in out[label].items()
                     if k not in ("cached_ms", "cached_match_arrays_ms")},
                    ensure_ascii=False), flush=True)
            if path == "single":
                # the iterator over the resident Corpus: one match_arrays
                # call, then the batched walk, in input order
                t0 = time.perf_counter()
                it = _indices_rows(Matcher.from_query(
                    "deadbeef").match_iter_indices(corpora["ascii"]))
                assert it and it == sorted(fuzzy_rows, key=lambda r: r[1]), (
                    "match_iter_indices != match_list_indices")
                del fuzzy_rows
                out["iter_deadbeef"] = {
                    "count": len(it), "seconds": time.perf_counter() - t0}
            torch.cuda.synchronize()
            serving[INDICES_PATHS[path]] = {
                "launches": dict(_build.LAUNCHES)}
    finally:
        fm.Matcher.match_arrays = match_arrays
        tb.batched_match_indices = batched
    detail["indices"] = out


# the native phase: rows of datagen.xl_heavy_corpus (wider than the widest
# bucket) beside the 1M main rows, and greedy Arabic rows (_greedy_rows)
# beside the 1M Arabic rows; the hooked per-row twin scores every
# candidate in Python, so these counts bound the phase's time
NATIVE_XL_ROWS = 128
NATIVE_GREEDY_ROWS = 256


def _buckets_equal(label, a, b):
    assert len(a.buckets) == len(b.buckets), label
    assert np.array_equal(a.xl_indices, b.xl_indices), label
    for x, y in zip(a.buckets, b.buckets):
        assert x.width == y.width, label
        for name in ("indices", "cp", "n_units", "n_bytes"):
            u, v = getattr(x, name), getattr(y, name)
            assert u.dtype == v.dtype and np.array_equal(u, v), (
                f"{label}: bucket w{x.width} {name} differs between the "
                f"native packer and its NumPy twin")


def _hooked(native, fn, *args, **kw):
    """``fn`` with the engines' and the packer's NumPy twins
    (``native._FORCE_NUMPY``)."""
    native._FORCE_NUMPY = True
    try:
        return fn(*args, **kw)
    finally:
        native._FORCE_NUMPY = False


def native_phase(hay, uhay, detail):
    """The native host components at 1M rows, each against its NumPy or
    per-row twin (the test hook ``native._FORCE_NUMPY``):

    (a) the packer: the main ASCII rows and the Arabic rows packed on the
        host by the native packer and by its NumPy twin, every bucket
        array equal, both timed;
    (b) XL rows: the 1M main rows plus NATIVE_XL_ROWS rows of
        ``datagen.xl_heavy_corpus`` (most wider than the widest bucket),
        served at Q=32, k=TOP_K as fuzzy T=0,
        fuzzy T=1 and multi batches; the native host fixups (XL rows off
        the corpus's encoded blob) and the per-row twin give equal
        results, and some XL row is served;
    (c) greedy rows: the 1M Arabic rows plus NATIVE_GREEDY_ROWS rows of
        ``_greedy_rows``, fuzzy and multi at Q=UQ, the same way, and some
        greedy row is served.

    The host fixups' time (``Matcher._host_fixups``, host clock) is
    summed per batch each way."""
    from frizbee_tpu_torch import Config, datagen, match_topk_batch, native
    from frizbee_tpu_torch import pack_corpus
    from frizbee_tpu_torch import matcher as fm

    out = {}
    for label, rows, unicode in (("pack_ascii", hay, False),
                                 ("pack_arabic", uhay, True)):
        t0 = time.perf_counter()
        nat = pack_corpus(rows, unicode=unicode, device="cpu")
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = _hooked(native, pack_corpus, rows, unicode=unicode,
                       device="cpu")
        numpy_s = time.perf_counter() - t0
        _buckets_equal(label, nat, twin)
        out[label] = {"rows": len(rows), "native_s": native_s,
                      "numpy_s": numpy_s,
                      "buckets": [(b.width, b.size) for b in nat.buckets]}
        del nat, twin
        print(f"native phase, {label}: " + json.dumps(out[label]),
              flush=True)

    fixup_s = []
    # rows past first_extra[0] (the XL or greedy rows) the fixups served,
    # and greedy-flagged rows they rescored
    first_extra = [0]
    served = {"extra": 0, "greedy": 0}
    host_fixups = fm.Matcher._host_fixups

    def timed_fixups(self, *args):
        t0 = time.perf_counter()
        try:
            res = host_fixups(self, *args)
        finally:
            fixup_s.append(time.perf_counter() - t0)
        served["extra"] += int((res[0] >= first_extra[0]).sum())
        served["greedy"] += int(np.asarray(args[-1]).sum())
        return res

    def serve(label, corpus, queries, cfg, extra_from):
        """Both ways, native first, the results equal; some row past
        ``extra_from`` is served."""
        first_extra[0] = extra_from
        res, ms = [], []
        for hook in (False, True):
            fixup_s.clear()
            served.update(extra=0, greedy=0)
            t0 = time.perf_counter()
            if hook:
                got = _hooked(native, match_topk_batch, queries, corpus,
                              cfg, k=TOP_K)
            else:
                got = match_topk_batch(queries, corpus, cfg, k=TOP_K)
            ms.append(((time.perf_counter() - t0) * 1e3,
                       sum(fixup_s) * 1e3))
            res.append(got)
            if not hook:
                rows_served = dict(served)
        for x, y in zip(*res):
            assert x[0] == y[0], label
            for u, v in zip(x[1:], y[1:]):
                assert np.array_equal(u, v), (
                    f"{label}: native host fixups differ from the twin")
        assert rows_served["extra"] > 0, (
            f"{label}: no XL or greedy row served")
        out[label] = {
            "queries": len(queries), "k": TOP_K,
            "max_typos": cfg.max_typos,
            "counts": [int(x[0]) for x in res[0]],
            "extra_rows_served": rows_served["extra"],
            "greedy_rows_rescored": rows_served["greedy"],
            "native_batch_ms": ms[0][0], "native_fixups_ms": ms[0][1],
            "numpy_batch_ms": ms[1][0], "numpy_fixups_ms": ms[1][1],
        }
        print(f"native phase, {label}: " + json.dumps(
            {k: v for k, v in out[label].items() if k != "counts"}),
            flush=True)

    fm.Matcher._host_fixups = timed_fixups
    try:
        xl_hay = hay + datagen.xl_heavy_corpus(num_samples=NATIVE_XL_ROWS,
                                               seed=7)
        corpus = pack_corpus(xl_hay)
        # the generator's lengths spread around 2048: the rows of 1024
        # units or fewer land in the widest bucket
        out["xl_rows_past_buckets"] = len(corpus.xl_indices)
        assert len(corpus.xl_indices) > NATIVE_XL_ROWS // 2
        # a first batch builds the corpus's device blocks and XL blob
        match_topk_batch(_queries(2), corpus, Config(), k=TOP_K)
        for label, queries, cfg in (
                ("xl_fuzzy_t0", _queries(Q), Config(max_typos=0)),
                ("xl_fuzzy_t1", _queries(Q), Config(max_typos=1)),
                ("xl_multi", _multi_queries(Q), Config())):
            serve(label, corpus, queries, cfg, len(hay))
            assert out[label]["greedy_rows_rescored"] == 0, label
        del corpus, xl_hay
        g_hay = uhay + _greedy_rows(NATIVE_GREEDY_ROWS)
        ucorpus = pack_corpus(g_hay, unicode=True)
        queries = _unicode_queries(UQ, kind=4)
        match_topk_batch(queries[:2], ucorpus, Config(), k=TOP_K)
        for label, qs, cfg in (
                ("greedy_fuzzy", queries, Config(max_typos=1)),
                ("greedy_multi", [p[:4] + " " + p[4:] for p in queries],
                 Config(max_typos=0))):
            serve(label, ucorpus, qs, cfg, len(uhay))
            assert out[label]["greedy_rows_rescored"] > 0, label
        del ucorpus, g_hay
    finally:
        fm.Matcher._host_fixups = host_fixups
    out["xl_rows"] = NATIVE_XL_ROWS
    out["greedy_rows"] = NATIVE_GREEDY_ROWS
    detail["native"] = out


PARALLEL_SHARDS = 4
PARALLEL_TIMED = 3  # profiling.wall_time iterations a batch and mesh
PARALLEL_GREEDY_BASE = 20_000  # (c): partial-match rows before the greedy
PARALLEL_GREEDY_ROWS = 256  # and XL rows
PARALLEL_XL_ROWS = 64
PARALLEL_GLOO_ROWS = 100_000  # (e): each rank's corpus
PARALLEL_GLOO_Q = 8
PARALLEL_GLOO_TIMEOUT = 240
# (a)'s batches whose launches at PARALLEL_SHARDS shards are captured for
# the timing phase (with (c)'s), held there to the plain version
PARALLEL_CAPTURED = ("fuzzy", "full_syntax", "unicode_fuzzy")


def _full_syntax_batch():
    """The Q=8 full-syntax batch (as the reference's parallel tests):
    fuzzy T=1, a negation veto, the three literal modes, a multi-pattern
    sum, fuzzy T=2 and the empty query (the host copy path)."""
    from frizbee_tpu_torch import Config, Matcher

    cfg = Config(max_typos=1)
    return [Matcher("dead", cfg), Matcher.from_query("dead !beef", cfg),
            Matcher.from_query("'dead", cfg), Matcher.from_query("^dead", cfg),
            Matcher.from_query("beef$", cfg),
            Matcher.from_query("dead beef", cfg),
            Matcher("dead", Config(max_typos=2)), Matcher("", cfg)]


def _topk_equal(label, got, want):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"{label}: query {i} count {g[0]} != {w[0]}"
        for a, b in zip(g[1:], w[1:]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (
                f"{label}: query {i} rows differ from single-device serving")


def _gloo_rank(rank, world, init, rows):
    """One rank of the parallel phase's gloo world (a process of its own,
    driving the card as ``cuda:(rank % device_count)``): a corpus made
    from the same seed in every rank, the fuzzy and full-syntax batches
    through ``match_topk_batch_sharded`` and fuzzy "deadbeef" through
    ``match_corpus_sharded``, each equal to this rank's single-device
    serving; then the fuzzy batch timed. Prints one ``PARALLEL_GLOO_OK``
    line of JSON; tears the group down also on failure."""
    import torch.distributed as dist

    from frizbee_tpu_torch import (Config, Matcher, datagen, match_topk_batch,
                                   pack_corpus, profiling)
    from frizbee_tpu_torch.engine import make_engine
    from frizbee_tpu_torch.parallel import (initialize_distributed,
                                            match_corpus_sharded,
                                            match_topk_batch_sharded)

    rank, world, rows = int(rank), int(world), int(rows)
    mesh = initialize_distributed(backend="gloo", init_method=init,
                                  world_size=world, rank=rank, device="cuda")
    try:
        hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                           num_samples=rows)
        corpus = pack_corpus(hay)
        cfg = Config()
        queries = _queries(PARALLEL_GLOO_Q)
        out = {"rank": rank, "device": str(mesh.devices[0]),
               "backend": dist.get_backend()}
        for label, qs in (("fuzzy", queries),
                          ("full_syntax", _full_syntax_batch())):
            want = match_topk_batch(qs, corpus, cfg, k=TOP_K)
            got = match_topk_batch_sharded(qs, corpus, mesh, cfg, k=TOP_K)
            _topk_equal(f"gloo rank {rank} {label}", got, want)
            out[f"{label}_counts"] = [int(r[0]) for r in got]
        got = match_corpus_sharded(corpus, make_engine("deadbeef", cfg),
                                   mesh, k=TOP_K)
        want = Matcher("deadbeef", cfg).match_arrays(corpus)
        for a, b in zip(got, want):
            assert np.array_equal(a, b[:TOP_K]), f"gloo rank {rank} corpus"
        out["corpus_rows_returned"] = len(got[0])
        out["fuzzy_batch_ms"] = 1e3 * profiling.wall_time(
            match_topk_batch_sharded, queries, corpus, mesh, cfg, k=TOP_K,
            iters=PARALLEL_TIMED)
        print("PARALLEL_GLOO_OK " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _gloo_world(detail_out):
    """(e): two ranks over gloo, each a subprocess on the card, a file
    rendezvous in a temporary directory; fails unless both exit 0 with
    their OK lines inside PARALLEL_GLOO_TIMEOUT seconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        code = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke._gloo_rank(*sys.argv[1:]))")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), "2", init,
             str(PARALLEL_GLOO_ROWS)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, PARALLEL_GLOO_TIMEOUT
                                - (time.perf_counter() - t0)))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    ranks = []
    for p, o in zip(procs, outs):
        lines = [x for x in o.splitlines() if x.startswith("PARALLEL_GLOO_OK")]
        assert p.returncode == 0 and lines, (
            f"gloo rank exited {p.returncode}:\n{o[-3000:]}")
        ranks.append(json.loads(lines[0].split(" ", 1)[1]))
    detail_out["gloo"] = {"rows": PARALLEL_GLOO_ROWS,
                          "queries": PARALLEL_GLOO_Q,
                          "seconds": time.perf_counter() - t0,
                          "ranks": ranks}


def parallel_phase(corpus, ucorpus, serving, detail):
    """Mesh-sharded serving (``frizbee_tpu_torch/parallel.py``) on the
    card, every result bit-equal to single-device serving:

    (a) single controller: ``match_topk_batch_sharded`` on ``make_mesh(1)``
        and on ``make_mesh(4, device="cuda")`` (four shards on the one
        card), k=TOP_K, equal to ``match_topk_batch`` on the same corpus,
        for the Q=32 fuzzy batch, the Q=8 full-syntax batch, the four
        sort strategies at Q=2 and the Q=16 Arabic fuzzy batch; each
        timed with ``profiling.wall_time`` beside single-device;
    (b) ``match_corpus_sharded`` at 4 shards, fuzzy T=0 and T=1, equal to
        the first k of ``Matcher.match_arrays``;
    (c) PARALLEL_GREEDY_BASE partial-match rows, PARALLEL_GREEDY_ROWS
        ``_greedy_rows`` and PARALLEL_XL_ROWS ``datagen.xl_heavy_corpus``
        rows as a codepoint corpus: a Q=8 batch (four "deadbeef"
        permutations and four eight-codepoint Arabic needles, T=1, under
        ``UnicodeMatching.ALWAYS``) at 4 shards, equal to single-device,
        some greedy row served;
    (d) a world of one over NCCL in this process
        (``initialize_distributed(backend="nccl")``, a file rendezvous),
        the fuzzy batch equal to (a)'s, timed; the group torn down;
    (e) two ranks over gloo, each a subprocess on the card
        (:func:`_gloo_world`).

    The sharded calls of (a)-(d) are the paths ``parallel`` (ASCII rows:
    ``match_units`` in int16 lanes) and ``parallel_unicode`` (codepoint
    rows: int32), each launch counter set to 0 just before each call and
    added up just after; no other kernel may launch there. Returns, per
    path, the launches (``_build.CAPTURE``) of its PARALLEL_CAPTURED
    batches at PARALLEL_SHARDS shards and of (c), and their queries."""
    import tempfile

    import torch.distributed as dist

    from frizbee_tpu_torch import (Config, Matcher, SortStrategy,
                                   UnicodeMatching, datagen,
                                   match_topk_batch, pack_corpus, profiling)
    from frizbee_tpu_torch.engine import make_engine
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, match_corpus_sharded,
                                            match_topk_batch_sharded)

    torch.cuda.reset_peak_memory_stats()
    launches = {"parallel": {k: 0 for k in _build.LAUNCHES},
                "parallel_unicode": {k: 0 for k in _build.LAUNCHES}}
    captured = {"parallel": ([], []), "parallel_unicode": ([], [])}

    def sharded(path, fn, *args, capture=None, **kw):
        _reset_counters()
        _build.CAPTURE = None if capture is None else []
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if capture is not None:
            captured[path][0].extend(_build.CAPTURE)
            captured[path][1].extend(capture)
        _build.CAPTURE = None
        for k, v in _build.LAUNCHES.items():
            launches[path][k] += v
        return out

    def ms(fn, *args, **kw):
        return 1e3 * profiling.wall_time(fn, *args, iters=PARALLEL_TIMED,
                                         **kw)

    out = {"shards": PARALLEL_SHARDS, "top_k": TOP_K, "batches": {}}
    meshes = {"1": make_mesh(1),
              str(PARALLEL_SHARDS): make_mesh(PARALLEL_SHARDS, device="cuda")}
    batches = [("fuzzy", corpus, _queries(Q), Config()),
               ("full_syntax", corpus, _full_syntax_batch(), Config())]
    batches += [(f"sort_{s.name.lower()}", corpus, _queries(2),
                 Config(sort=s)) for s in SortStrategy]
    batches.append(("unicode_fuzzy", ucorpus, _unicode_queries(UQ),
                    Config()))
    fuzzy_want = None
    for label, c, queries, cfg in batches:
        path = "parallel_unicode" if c.unicode else "parallel"
        want = match_topk_batch(queries, c, cfg, k=TOP_K)
        rec = {"queries": len(queries),
               "counts": [int(r[0]) for r in want],
               "single_ms": ms(match_topk_batch, queries, c, cfg, k=TOP_K)}
        for name, mesh in meshes.items():
            got = sharded(path, match_topk_batch_sharded, queries, c, mesh,
                          cfg, k=TOP_K,
                          capture=(queries if name == str(PARALLEL_SHARDS)
                                   and label in PARALLEL_CAPTURED else None))
            _topk_equal(f"parallel {label} at {name} shards", got, want)
            rec[f"shards_{name}_ms"] = ms(match_topk_batch_sharded, queries,
                                          c, mesh, cfg, k=TOP_K)
        out["batches"][label] = rec
        if label == "fuzzy":
            fuzzy_want = want
        print(f"parallel phase, {label}: " + json.dumps(
            {k: v for k, v in rec.items() if k != "counts"}), flush=True)

    mesh = meshes[str(PARALLEL_SHARDS)]
    for typos in (0, 1):
        cfg = Config(max_typos=typos)
        t0 = time.perf_counter()
        got = sharded("parallel", match_corpus_sharded, corpus,
                      make_engine("deadbeef", cfg), mesh, k=TOP_K)
        sharded_ms = (time.perf_counter() - t0) * 1e3
        want = Matcher("deadbeef", cfg).match_arrays(corpus)
        for a, b in zip(got, want):
            assert np.array_equal(a, b[:TOP_K]), (
                f"parallel match_corpus_sharded T={typos}")
        out[f"match_corpus_t{typos}"] = {"rows_returned": len(got[0]),
                                         "matches": len(want[0]),
                                         "first_call_ms": sharded_ms}
        print(f"parallel phase, match_corpus_sharded T={typos}: "
              + json.dumps(out[f"match_corpus_t{typos}"]), flush=True)

    hay = (datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                        num_samples=PARALLEL_GREEDY_BASE)
           + _greedy_rows(PARALLEL_GREEDY_ROWS)
           + datagen.xl_heavy_corpus(num_samples=PARALLEL_XL_ROWS, seed=7))
    gcorpus = pack_corpus(hay, unicode=True)
    gcfg = Config(max_typos=1, unicode=UnicodeMatching.ALWAYS)
    queries = _queries(4) + _unicode_queries(4, kind=4)
    want = match_topk_batch(queries, gcorpus, gcfg, k=TOP_K)
    got = sharded("parallel_unicode", match_topk_batch_sharded, queries,
                  gcorpus, mesh, gcfg, k=TOP_K, capture=queries)
    _topk_equal("parallel greedy/XL", got, want)
    lo, hi = PARALLEL_GREEDY_BASE, PARALLEL_GREEDY_BASE + PARALLEL_GREEDY_ROWS
    greedy_served = sum(int(((r[1] >= lo) & (r[1] < hi)).sum()) for r in got)
    assert greedy_served > 0, "parallel greedy/XL: no greedy row served"
    out["greedy_xl"] = {"rows": len(hay), "xl_rows": len(gcorpus.xl_indices),
                        "counts": [int(r[0]) for r in got],
                        "greedy_rows_served": greedy_served}
    print("parallel phase, greedy/XL: " + json.dumps(out["greedy_xl"]),
          flush=True)
    del gcorpus, hay

    with tempfile.TemporaryDirectory() as tmp:
        nccl = initialize_distributed(
            backend="nccl", init_method="file://" + os.path.join(tmp, "rdv"),
            world_size=1, rank=0, device="cuda")
        try:
            queries = _queries(Q)
            got = sharded("parallel", match_topk_batch_sharded, queries,
                          corpus, nccl, Config(), k=TOP_K)
            _topk_equal("parallel nccl world of one", got, fuzzy_want)
            out["nccl_world_of_one"] = {
                "backend": dist.get_backend(),
                "fuzzy_batch_ms": ms(match_topk_batch_sharded, queries,
                                     corpus, nccl, Config(), k=TOP_K)}
        finally:
            dist.destroy_process_group()
    print("parallel phase, NCCL world of one: "
          + json.dumps(out["nccl_world_of_one"]), flush=True)

    _gloo_world(out)
    print("parallel phase, gloo two ranks: " + json.dumps(
        {"seconds": out["gloo"]["seconds"],
         "fuzzy_batch_ms": [r["fuzzy_batch_ms"] for r in out["gloo"]["ranks"]],
         "devices": [r["device"] for r in out["gloo"]["ranks"]]}),
        flush=True)

    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    for path, counts in launches.items():
        name = "match_units" if path == "parallel_unicode" else \
            "match_units_i16"
        assert counts[name] > 0, (path, counts)
        others = {k: v for k, v in counts.items() if k != name and v}
        assert not others, (f"{path}: the sharded body launched "
                            f"{others}")
        serving[path] = {"launches": counts}
    out["launches"] = launches
    detail["parallel"] = out
    return captured


# the generic pipelines at 1M rows: (label, corpus key, queries, config
# keywords, the ops.batch.GENERIC_ROUTES entry every group must take, the
# launch counters the path must raise, timed blocking batches after the
# cold one). Index sorts and multi-pattern atoms beyond the colstream
# budgets take the generic body over the row-major kernel (int16 lanes
# on byte rows, int32 on codepoints); literal needles over 16 units the
# literal fast path; needles over 64 units and budgets over 8 the plain
# fuzzy pipeline over PackedBucket.device_arrays()
GENERIC_TIMED_CALLS = 3
GENERIC_LONG_FUZZY = 4


def _long_literal_queries(hay, q, seed=12):
    """``^`` prefixes of 17-32 bytes cut from seeded sampled rows (a
    pasted path prefix): each matches at least its own row."""
    rng = np.random.default_rng(seed)
    rows = [h for h in hay[:200_000] if len(h) >= 32]
    picks = rng.choice(len(rows), q, replace=False)
    return ["^" + rows[j][:17 + i % 16] for i, j in enumerate(picks)]


def _multi_long_queries(q):
    """A 17-24-unit fuzzy atom (cut from the long needle's permutations,
    the needle itself first) and a negated literal atom, the 4-byte
    prefix of a "cafebabe" permutation: eight shape groups of q // 8."""
    perms = _queries(q, LONG_NEEDLE)
    other = _queries(q, "cafebabe")
    return [f"{p[:17 + i % 8]} !^{o[:4]}"
            for i, (p, o) in enumerate(zip(perms, other))]


def _long_fuzzy_queries(hay, seed=13):
    """(needles over 64 units: whole sampled rows of 65-96 bytes, the
    w128 bucket's; 16-unit needles, for T=10)."""
    rng = np.random.default_rng(seed)
    rows = [h for h in hay[:200_000] if 65 <= len(h.encode()) <= 96]
    picks = rng.choice(len(rows), GENERIC_LONG_FUZZY, replace=False)
    short = [h for h in hay[:200_000] if len(h) >= 16]
    spicks = rng.choice(len(short), GENERIC_LONG_FUZZY, replace=False)
    return [rows[j] for j in picks], [short[j][:16] for j in spicks]


def _generic_paths(corpora, hay):
    """label -> (corpus, queries, Config, route, kernels, timed calls)."""
    from frizbee_tpu_torch import Config, SortStrategy

    long_q, short_q = _long_fuzzy_queries(hay)
    return {
        "index_sort": (corpora["ascii"], _queries(Q),
                       Config(sort=SortStrategy.INDEX_ASC), "kernel_body",
                       ("match_units_i16",), GENERIC_TIMED_CALLS),
        "index_sort_unicode": (corpora["arabic"], _unicode_queries(UQ),
                               Config(sort=SortStrategy.INDEX_DESC),
                               "kernel_body", ("match_units",),
                               GENERIC_TIMED_CALLS),
        "multi_long": (corpora["long"], _multi_long_queries(Q), Config(),
                       "kernel_body", ("match_units_i16",),
                       GENERIC_TIMED_CALLS),
        "long_literal": (corpora["ascii"], _long_literal_queries(hay, Q),
                         Config(), "literal_fast", (), GENERIC_TIMED_CALLS),
        "long_fuzzy": (corpora["ascii"], long_q, Config(max_typos=0),
                       "pipeline_body", (), 1),
        "long_fuzzy_t10": (corpora["ascii"], short_q, Config(max_typos=10),
                           "pipeline_body", (), 1),
    }


def generic_phase(gpaths, serving, detail):
    """The generic pipelines at 1M rows through ``match_topk_batch``, each
    path with every counter set to 0 just before it and read just after:
    one cold batch and the median of its timed blocking batches (host
    clock, ending in a synchronise), peak device memory; asserts the
    route every group took, the kernels it must launch (none launches
    another), its counts against the score-sorted batches of the same
    needles, the index order of the index sorts and a match for every
    long literal."""
    from frizbee_tpu_torch import match_topk_batch
    from frizbee_tpu_torch.matcher import Matcher, _dispatch_batch_groups
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import batch as fb

    out = {}
    for label, (corpus, queries, cfg, route, kernels, timed) in \
            gpaths.items():
        _reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = match_topk_batch(queries, corpus, cfg, k=TOP_K)
        cold_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            res = match_topk_batch(queries, corpus, cfg, k=TOP_K)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(_build.LAUNCHES)
        routes = dict(fb.GENERIC_ROUTES)
        groups = len({(m._statics(), tuple(
            len(c.engine.units.orig) for c in m._compiled))
            for m in (Matcher.from_query(q, cfg) for q in queries)})
        batches = 1 + timed
        assert routes[route] == groups * batches and sum(
            routes.values()) == routes[route], (label, routes, groups)
        for name in ("match_units", "match_units_i16", "colstream_fuzzy",
                     "colstream_literal", "row_gather"):
            assert (launches[name] > 0) == (name in kernels), (
                label, launches)
        counts = [int(r[0]) for r in res]
        assert sum(counts) > 0, f"{label}: nothing matched"
        med = float(np.median(times))
        out[label] = {
            "corpus_rows": len(corpus), "batch_queries": len(queries),
            "groups": groups, "top_k": TOP_K, "max_typos": cfg.max_typos,
            "sort": cfg.sort.name, "route": route,
            "cold_batch_ms": cold_ms, "blocking_batch_ms": times,
            "blocking_median_ms": med,
            "blocking_haystacks_per_sec": len(queries) * len(corpus)
            / (med / 1e3),
            "peak_device_memory_bytes": peak, "launches": launches,
            "generic_routes": routes, "match_counts": counts,
        }
        serving[label] = {"launches": launches}
        if label.startswith("index_sort"):
            base = serving["unicode_fuzzy" if "unicode" in label
                           else "fuzzy"]
            assert counts == base["match_counts"], (label, counts)
            step = 1 if cfg.sort.name == "INDEX_ASC" else -1
            for r in res:
                assert np.all(np.diff(r[1]) * step > 0), label
        if label == "long_literal":
            assert min(counts) >= 1, counts
        print(f"generic phase, {label}: " + json.dumps(
            {k: v for k, v in out[label].items()
             if k not in ("match_counts", "blocking_batch_ms")},
            ensure_ascii=False), flush=True)
        del res
    detail["generic"] = out


def generic_cpu_parity_phase(detail):
    """Reduced size (20k rows): the card's arrays equal the CPU's on every
    generic path — the serving arrays group by group and the decoded
    top-k of each path of the generic phase, custom bucket widths (48,)
    and (64, 128, 2048), INDEX_DESC and SCORE_THEN_INDEX_DESC — and so do
    ``Matcher.match_arrays`` over atoms of mixed unit modes (the repack
    in the other mode on the corpus device) and ``match_list_indices``
    under INDEX_ASC."""
    from frizbee_tpu_torch import (Config, SortStrategy, datagen,
                                   match_topk_batch, pack_corpus)
    from frizbee_tpu_torch.matcher import Matcher, _dispatch_batch_groups

    n_rows, q = 20_000, 8
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=n_rows, seed=9)
    long_hay = _long_corpus(n_rows, seed=9)
    arabic = _unicode_corpus(n_rows, "arabic", seed=9)
    long_q, short_q = _long_fuzzy_queries(hay, seed=14)
    wide_hay = hay + ["dead" + "x" * int(k) + "beef"
                      for k in np.random.default_rng(9).integers(
                          200, 1900, 200)]
    idx_asc = Config(sort=SortStrategy.INDEX_ASC)
    cases = [
        ("index_sort", hay, _queries(q), idx_asc, False, None),
        ("index_sort T=1", hay, _queries(q), Config(
            sort=SortStrategy.INDEX_ASC, max_typos=1), False, None),
        ("index_sort_unicode", arabic, _unicode_queries(q),
         Config(sort=SortStrategy.INDEX_DESC), True, None),
        ("multi_long", long_hay, _multi_long_queries(q), Config(), False,
         None),
        ("long_literal", hay, _long_literal_queries(hay, q), Config(),
         False, None),
        ("long_fuzzy", hay, long_q[:2], Config(max_typos=0), False, None),
        ("long_fuzzy T=10", hay, short_q[:2], Config(max_typos=10), False,
         None),
        ("INDEX_DESC", hay, _queries(q), Config(
            sort=SortStrategy.INDEX_DESC), False, None),
        ("SCORE_THEN_INDEX_DESC", hay, _queries(q), Config(
            sort=SortStrategy.SCORE_THEN_INDEX_DESC), False, None),
        ("widths (48,)", hay, _queries(4), Config(), False, (48,)),
        ("widths (64, 128, 2048) INDEX_DESC", wide_hay, ["dead", "beef"],
         Config(sort=SortStrategy.INDEX_DESC), False, (64, 128, 2048)),
    ]
    seconds = {}
    packed = {}
    for label, rows, queries, cfg, unicode, widths in cases:
        t0 = time.perf_counter()
        key = (id(rows), widths)
        if key not in packed:
            kw = {} if widths is None else {"bucket_widths": widths}
            packed[key] = (pack_corpus(rows, unicode=unicode, **kw),
                           pack_corpus(rows, unicode=unicode, device="cpu",
                                       **kw))
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
        assert len(raw[0]) == len(raw[1]) > 0, label
        for (a, ma), (b, mb) in zip(*raw):
            assert ma == mb and np.array_equal(a, b), (
                f"card and CPU serving arrays differ: {label}")
        got = match_topk_batch(queries, on_card, cfg, k=TOP_K)
        want = match_topk_batch(queries, on_cpu, cfg, k=TOP_K)
        for x, y in zip(got, want):
            assert x[0] == y[0], label
            for u, v in zip(x[1:], y[1:]):
                assert np.array_equal(u, v), label
        assert sum(x[0] for x in got) > 0, f"{label}: nothing matched"
        seconds[label] = time.perf_counter() - t0
    # atoms of mixed unit modes: the engines' device match_corpus
    mixed = hay[:n_rows // 2] + arabic[:n_rows // 2] + [
        "abc " + h for h in arabic[:200]] + ["إن dead" + h for h in hay[:200]]
    on_card = pack_corpus(mixed)
    on_cpu = pack_corpus(mixed, device="cpu")
    for query in ("abc إن", "إن 'dead"):
        t0 = time.perf_counter()
        m = Matcher.from_query(query)
        got, want = m.match_arrays(on_card), m.match_arrays(on_cpu)
        assert len(got[0]) > 0, query
        for u, v in zip(got, want):
            assert np.array_equal(u, v), f"mixed unit modes: {query}"
        seconds[f"mixed {query}"] = time.perf_counter() - t0
    # matched-character indices under an index sort
    t0 = time.perf_counter()
    got = Matcher.from_query("deadbeef", idx_asc).match_list_indices(hay)
    want = Matcher.from_query("deadbeef", idx_asc,
                              device="cpu").match_list_indices(hay)
    rows_of = [(m.index, m.score, m.exact, list(m.indices)) for m in got]
    assert rows_of and rows_of == [
        (m.index, m.score, m.exact, list(m.indices)) for m in want]
    assert [r[0] for r in rows_of] == sorted(r[0] for r in rows_of)
    seconds["match_list_indices INDEX_ASC"] = time.perf_counter() - t0
    detail["generic_cpu_parity_seconds"] = seconds
    print(f"generic card-vs-CPU phase ({n_rows} rows): equal, seconds "
          f"{json.dumps(seconds, ensure_ascii=False)}", flush=True)


def single_profile_phase(corpora, detail):
    """Device busy and idle share of cached single-query calls, for
    "deadbeef" and the broad needle (torch.profiler)."""
    from frizbee_tpu_torch import Matcher

    for label, key, q, cfg, _k in SINGLE_QUERIES:
        if label not in ("fuzzy", "broad"):
            continue
        m = Matcher.from_query(q)
        m.match_arrays(corpora[key])
        _profile(f"single_{label}", lambda: m.match_arrays(corpora[key]),
                 5, detail, {"query": q})


def _profile(label, fn, reps, detail, extra, keep_trace=False):
    """torch.profiler over ``reps`` blocking calls of ``fn``, each inside
    ``profiling.annotate``: wall time, device busy time and idle share a
    call, peak device memory, and the top device kernels and host
    operations; the annotation must appear among the profiler's events.
    With ``keep_trace`` the profiler is ``profiling.trace``, whose Chrome
    trace stays under ``chiprun_out/traces/`` (its path and size
    printed). Returns the detail entry."""
    from torch.profiler import ProfilerActivity

    from frizbee_tpu_torch import profiling

    span = f"{label}_call"
    trace_dir = os.path.join(OUT_DIR, "traces")
    torch.cuda.reset_peak_memory_stats()
    with (profiling.trace(label, log_dir=trace_dir) if keep_trace
          else torch.profiler.profile(activities=[
              ProfilerActivity.CPU, ProfilerActivity.CUDA])) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            with profiling.annotate(span):
                fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    trace_file = trace_bytes = None
    if keep_trace:
        trace_file = max(glob.glob(os.path.join(trace_dir, f"{label}-*.json")),
                         key=os.path.getmtime)
        trace_bytes = os.path.getsize(trace_file)
    peak = torch.cuda.max_memory_allocated()
    events = prof.key_averages()
    spans = [e for e in events if e.key == span]
    assert spans and spans[0].count >= reps, (
        f"{label}: the annotation {span!r} is not among the profiler's "
        "events")
    events = [e for e in events if e.key != span]

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
        **extra,
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "peak_device_memory_bytes": peak,
        "trace": trace_file and os.path.relpath(trace_file, ROOT),
        "trace_bytes": trace_bytes,
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
    detail.setdefault("profile", {})[label] = out
    print(f"profile phase, {label}: " + json.dumps({
        k: out[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                            "device_idle_share")
    }) + " top device: " + json.dumps(out["top_device_ms_per_batch"][:5]),
        flush=True)
    if keep_trace:
        print(f"profile phase, {label}: trace {out['trace']}, "
              f"{trace_bytes} bytes", flush=True)
    return out


def profile_phase(label, corpus, queries, detail, host_profile=False):
    """Where a serving batch's time goes: :func:`_profile` over 3
    blocking batches; with ``host_profile``, cProfile over one more
    batch."""
    from frizbee_tpu_torch import Config, match_topk_batch

    out = _profile(
        label, lambda: match_topk_batch(queries, corpus, Config(), k=TOP_K),
        3, detail, {"batch_queries": len(queries)},
        keep_trace=label == "fuzzy")
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
    rate and int32 operations over the issue rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / ISSUE_OPS_PER_S
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
    # key-emit mode writes an int64 key a row, columns mode five int32
    # columns and reads no row index
    columns = not torch.is_tensor(keys)
    if columns:
        out_bytes = 4 * sum(c.numel() for c in keys)
        in_bytes -= float(read.sum()) * GROUP_ROWS * 4
        hit_of = keys[0] != 0
    else:
        out_bytes = 8 * keys.numel()
        hit_of = keys != INT64_MAX
    if "mode" in kw:
        ops = cols * (LIT_OPS_PER_CELL * n + LIT_OPS_PER_COLUMN)
        if cpT.dtype == torch.int32 and kw["mode"] in (EXACT, PREFIX):
            hit = hit_of.to(torch.float64)
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


def _transposed_work(args, kw, out):
    """The transposed recurrence: every row walks W columns of n cells;
    each unit read once (4 bytes), each row's best written once."""
    cpT, scal = args
    cells = float(cpT.numel()) * kw["n"]
    return (cells * TRANSPOSED_OPS_PER_CELL,
            float(cpT.numel() * 4 + scal.numel() * 4), float(out.numel() * 4))


def _bisect_work(args, kw, out):
    """A bisect stage: every row walks all W columns (n cells each), its
    units read once (4 bytes), its unit count read and five planes
    written."""
    stage, cpT, nuT, scal = args
    per_cell, per_col = BISECT_OPS[stage]
    cols = float(cpT.numel())
    return (cols * (per_cell * kw["n"] + per_col),
            float((cpT.numel() + nuT.numel() + scal.numel()) * 4),
            float(out.numel() * 4))


def _contract_work(args, _kw, out):
    """The contract launch: its inputs read and outputs written once, an
    operation per output element."""
    read = sum(a.numel() * a.element_size() for a in args)
    written = sum(o.numel() * o.element_size() for o in out)
    return float(sum(o.numel() for o in out)), float(read), float(written)


def _replay(entry, name, calls, errs, plain_ms=None):
    """Time the captured launches ``calls`` ((args, kwargs) of the
    wrapper) of one serving batch on the kernel, on its plain version and
    on the library call where there is one; the kernel's results are held
    bit-equal to the plain version's. Given ``plain_ms`` (the plain
    version's times on parts of ``calls`` that were already held equal,
    summed), the plain version does not run again. Returns the timing
    entry's numbers and the work this run's data needs."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import contract as ct
    from frizbee_tpu_torch.ops import kernels as km
    from frizbee_tpu_torch.probes import colstream_bisect as pb
    from frizbee_tpu_torch.probes import device_ms
    from frizbee_tpu_torch.probes import transposed as pt

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
        "probe_transposed": (pt.transposed_best, pt.transposed_best_plain,
                             _transposed_work, None),
        "probe_colstream_bisect": (pb.bisect_stage, pb.bisect_stage_plain,
                                   _bisect_work, None),
        "row_gather": (cs.row_gather, cs.row_gather_plain, _gather_work,
                       lambda data, rows: torch.index_select(data, 0, rows)),
    }[name]

    def run(fn):
        return [fn(*a, **kw) for a, kw in calls]

    got = run(kernel)
    if plain_ms is None:
        plain_ms, want = _time_once_ms(lambda: run(plain))
        for g, w in zip(got, want):
            _check_equal(errs, entry, g, w, "serving shapes")
        del want
    ops = in_bytes = out_bytes = 0.0
    for (a, kw), out in zip(calls, got):
        o, i, w = work(a, kw, out)
        ops, in_bytes, out_bytes = ops + o, in_bytes + i, out_bytes + w
    del got
    bound_ms, bound_by = _bound(in_bytes, out_bytes, ops)
    return {
        "ms": device_ms(lambda: run(kernel)),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": (None if library is None
                       else device_ms(lambda: run(library))),
    }, {"launches": len(calls), "ops": ops, "bytes": in_bytes + out_bytes}


KERNELS = (
    # entry, kernel (its launch counter), source, TPU kernel it replaces,
    # paths it runs on (the unicode launches of the match kernels are
    # entries of their own; single and single_unicode are the
    # single-query Matcher path's ASCII and Arabic calls, whose launch
    # counts add those of the indices phase's paths; fuzzy_int16 drives the fuzzy batch's colstream
    # launches with int16 lanes, typo_int32 and long_needle_int32 those
    # batches' row-major launches with int32 lanes, contract the contract
    # phase, parallel and parallel_unicode the parallel phase's sharded
    # serving, whose PARALLEL_CAPTURED batches at 4 shards and greedy/XL
    # batch are the ones captured)
    ("colstream_fuzzy", "colstream_fuzzy",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954", ("fuzzy", "multi", "single")),
    ("colstream_literal", "colstream_literal",
     "frizbee_tpu_torch/csrc/colstream_literal.cu",
     "frizbee_tpu/ops/colstream.py:954", ("literal", "multi", "single")),
    ("row_gather", "row_gather", "frizbee_tpu_torch/csrc/row_gather.cu",
     "frizbee_tpu/ops/colstream.py:749",
     ("fuzzy", "literal", "typo", "long_needle", "multi", "single")),
    ("row_gather_unicode", "row_gather",
     "frizbee_tpu_torch/csrc/row_gather.cu",
     "frizbee_tpu/ops/colstream.py:749",
     ("unicode_fuzzy", "unicode_literal", "unicode_typo", "unicode_multi",
      "single_unicode")),
    ("match_units", "match_units", "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632",
     ("typo_wide", "typo_int32", "long_needle_int32")),
    ("match_units_i16", "match_units_i16",
     "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632",
     ("typo", "long_needle", "single", "index_sort", "multi_long",
      "parallel")),
    ("colstream_fuzzy_i16", "colstream_fuzzy_i16",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954", ("fuzzy_int16",)),
    ("lane_contract", "lane_contract",
     "frizbee_tpu_torch/csrc/lane_contract.cu",
     "tests/test_kernel_contract.py:52", ("contract",)),
    ("colstream_fuzzy_unicode", "colstream_fuzzy",
     "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
     "frizbee_tpu/ops/colstream.py:954",
     ("unicode_fuzzy", "unicode_multi", "single_unicode")),
    ("colstream_literal_unicode", "colstream_literal",
     "frizbee_tpu_torch/csrc/colstream_literal.cu",
     "frizbee_tpu/ops/colstream.py:954", ("unicode_literal", "unicode_multi")),
    ("match_units_unicode", "match_units",
     "frizbee_tpu_torch/csrc/match_units.cu",
     "frizbee_tpu/ops/kernels.py:632",
     ("unicode_typo", "single_unicode", "index_sort_unicode",
      "parallel_unicode")),
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
    ``calls`` ((counter, (args, kwargs)) of the wrapper) of a match
    kernel run through their wrappers once, the counters read into
    ``serving[label]``."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km

    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    for name, (a, kw) in calls:
        fn = (km.match_units if name.startswith("match_units")
              else cs.match_units_colstream)
        fn(*a, **kw)
    torch.cuda.synchronize()
    serving[label] = {"launches": dict(_build.LAUNCHES)}


def ab_phase(calls, detail):
    """Row 8's timing half: the int32 and int16 instantiations of
    ``match_units`` on the typo and long-needle batches' served (int16)
    launches and of
    the colstream fuzzy kernel on the fuzzy batch's, in AB_ROUNDS rounds
    that alternate which goes first, each held bit-equal to the other
    first. Medians, the share of rounds the int16 one was faster, and the
    bound both share (the same work counted for both)."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops import kernels as km
    from frizbee_tpu_torch.probes import device_ms

    cases = {
        "match_units typo": ("typo", "match_units", km.match_units,
                             _match_units_work),
        "match_units long_needle": ("long_needle", "match_units",
                                    km.match_units, _match_units_work),
        "colstream_fuzzy fuzzy": ("fuzzy", "colstream_fuzzy",
                                  cs.match_units_colstream, _colstream_work),
    }
    out = {}
    for label, (path, name, fn, work) in cases.items():
        base = [c for k, c in calls[path] if k.removesuffix("_i16") == name]
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
                ms[v].append(device_ms(lambda: run(v)))
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


def timing_phase(paths, single, gpaths, pcalls, serving, errs, detail):
    """Each kernel's time at its serving shapes: the launches of one batch
    of each path it runs on, captured and replayed, beside their bound,
    their plain version and, for the row gather, ``torch.index_select``.
    The captures run after the serving phase has read its counters. The
    fuzzy batch's colstream launches are driven again with int16 lanes
    (which no serving path takes), the typo and long-needle batches'
    row-major launches with int32 lanes (which they no longer take), each
    a path of its own; then the int16/int32 A/B on the same launches.
    ``single`` holds the single-query paths' (path, [(corpus, query,
    config)]): one cached ``match_arrays`` call of each is captured.
    ``gpaths`` holds the generic phase's paths: one batch of each that
    launches a kernel is captured. ``pcalls`` holds the parallel phase's
    paths' captured launches and their queries."""
    calls = {label: _capture(c, queries, cfg)
             for label, (c, queries, cfg, _k) in paths.items()}
    paths_q = {label: p[1] for label, p in paths.items()}
    for path, calls_of in single:
        calls[path] = _capture_single(calls_of)
        paths_q[path] = [q for _c, q, _cfg in calls_of]
    for label, (c, queries, cfg, _r, kernels, _t) in gpaths.items():
        if kernels:
            calls[label] = _capture(c, queries, cfg)
            paths_q[label] = queries
    for label, (c, queries) in pcalls.items():
        calls[label], paths_q[label] = c, queries
    for path, name, lanes in (("fuzzy", "colstream_fuzzy", "int16"),
                              ("typo", "match_units", "int32"),
                              ("long_needle", "match_units", "int32")):
        label = f"{path}_{lanes}"
        calls[label] = [
            (name + ("_i16" if lanes == "int16" else ""),
             (a, dict(kw, int16_lanes=lanes == "int16")))
            for k, (a, kw) in calls[path] if k.removesuffix("_i16") == name]
        _drive(label, calls[label], serving)
        paths_q[label] = paths_q[path]
    entries = []
    detail.setdefault("timing", {})
    for entry, name, source, replaces, paths in KERNELS:
        if entry == "lane_contract":
            continue  # its entry comes from the contract phase
        per_path = {p: [c for k, c in calls[p] if k == name] for p in paths}
        assert any(per_path.values()), f"{entry}: no launch captured"
        # a kernel of several paths: each path's launches held equal and
        # timed, then all of them timed together, the plain version's time
        # the sum of its per-path runs (each launch runs it once)
        each = ({p: _replay(entry, name, c, errs)[0]
                 for p, c in per_path.items() if c}
                if len(paths) > 1 else None)
        nums, work = _replay(
            entry, name, sum(per_path.values(), []), errs,
            plain_ms=None if each is None else sum(
                x["plain_ms"] for x in each.values()))
        if each is not None:
            work["per_path"] = each
        work["per"] = "one batch of each of " + ", ".join(
            f"{p} ({'Q=1 x ' if p in SINGLE_PATHS else 'Q='}"
            f"{len(paths_q[p])})" for p in paths)
        detail["timing"][entry] = {**nums, **work}
        print(f"timing phase: {entry} " + json.dumps(detail["timing"][entry]),
              flush=True)
        entries.append({
            "name": entry, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(serving[p]["launches"][name] for p in paths)
            + sum(serving[INDICES_PATHS[p]]["launches"][name]
                  for p in paths if p in INDICES_PATHS),
            "max_abs_err": errs[entry],
            **nums,
        })
    ab_phase(calls, detail)
    return entries


# the row counts the contract kernel is held to its model at: the timed
# default 40 and counts that a warp a (row, lane type), eight warps a
# block, splits unevenly (tests/test_torch_lane_contract.py holds the model
# to the reference at the same counts)
CONTRACT_ROWS = (1, 33, 40, 97)
CONTRACT_SEED = 1


def _contract_mismatches(got, want, ins):
    """Per output that differs: the count, the columns and the first rows'
    inputs, kernel values and model values."""
    mism = {}
    for name, g, w, x in zip(("units", "pairs", "keys", "words", "rows"),
                             got, want, ins):
        bad = g != w
        if bad.any():
            if name == "rows":  # (2, R, ROW_OUT): rows of both lane types
                bad, g, w = (t.transpose(0, 1) for t in (bad, g, w))
            rows = bad.reshape(bad.shape[0], -1).any(dim=1).nonzero()[:8, 0]
            mism[name] = {
                "count": int(bad.sum()),
                "columns": (bad.reshape(bad.shape[0], -1).any(dim=0)
                            .nonzero()[:, 0].tolist())[:64],
                "inputs": x[rows].tolist(), "got": g[rows].tolist(),
                "want": w[rows].tolist()}
    return mism


def _ptxas_kernels(log):
    """Per kernel of an nvcc ``-Xptxas=-v`` log: registers, spill bytes
    and static shared memory bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        for field, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                           ("spill_loads", r"(\d+) bytes spill loads"),
                           ("registers", r"Used (\d+) registers"),
                           ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out.setdefault(cur, {})[field] = int(m.group(1))
    return out


def contract_phase(dev, errs, detail):
    """The lane contract kernel on its own path: every launch counter set
    to 0, one launch over ``contract.contract_inputs`` (CONTRACT_SEED, 40
    rows), the counters read; its outputs held bit-equal to
    ``contract.contract_plain`` (a mismatch names the outputs, rows and
    values that differ), then at the other row counts of CONTRACT_ROWS;
    then timed beside an empty kernel on the launch's grid
    (``lane_contract_empty_launch``, the floor any design of it pays), with
    the kernel's ptxas report. Returns its ``kernels`` entry."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.ops import contract as ct
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.probes import device_ms

    ins = ct.contract_inputs(seed=CONTRACT_SEED, device=dev)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    got = ct.lane_contract(*ins, DEFAULT_SCORING)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = ct.contract_plain(*ins, DEFAULT_SCORING)
    mism = {}
    checks = {ins[4].shape[0]: (got, want, ins)}
    for n in CONTRACT_ROWS:
        if n not in checks:
            ins_n = ct.contract_inputs(seed=CONTRACT_SEED, device=dev,
                                       n_rows=n)
            checks[n] = (ct.lane_contract(*ins_n, DEFAULT_SCORING),
                         ct.contract_plain(*ins_n, DEFAULT_SCORING), ins_n)
    for n, (g, w, x) in checks.items():
        m = _contract_mismatches(g, w, x)
        if m:
            mism[f"rows{n}"] = m
    detail["contract"] = {"launches": launches["lane_contract"],
                          "mismatches": mism,
                          "row_counts": sorted(checks),
                          "sizes": [int(t.shape[0]) for t in ins]}
    if mism:
        print("contract phase: MISMATCH " + json.dumps(mism), flush=True)
    for n, (g, w, _x) in checks.items():
        _check_equal(errs, "lane_contract", g, w, f"contract, {n} rows")
    del checks
    assert launches["lane_contract"] == 1, launches
    nums, work = _replay("lane_contract", "lane_contract",
                         [(ins, dict(scoring=DEFAULT_SCORING))], errs)
    empty = _build.library("lane_contract").lane_contract_empty_launch
    empty.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    counts = [int(t.shape[0]) for t in ins[:5]]

    def launch_empty():
        rc = empty(*counts, _build.stream(ins[0]))
        if rc:
            raise RuntimeError(f"lane_contract_empty launch failed: {rc}")

    floor_ms = device_ms(launch_empty)
    ptxas = _ptxas_kernels(detail.get("build", {}).get(
        "lane_contract", {}).get("ptxas", ""))
    detail.setdefault("timing", {})["lane_contract"] = {
        **nums, **work, "empty_launch_ms": floor_ms, "ptxas": ptxas}
    print(f"contract phase: lane_contract bit-equal to its plain model on "
          f"{detail['contract']['sizes'][:4]} units, byte pairs, keys and "
          f"s16x2 words and {sorted(detail['contract']['row_counts'])} "
          f"rows (int32 and int16 walks) "
          + json.dumps({**nums, "empty_launch_ms": floor_ms})
          + "; ptxas " + json.dumps(ptxas), flush=True)
    return {"name": "lane_contract", "route": "cuda",
            "source": "frizbee_tpu_torch/csrc/lane_contract.cu",
            "replaces": "tests/test_kernel_contract.py:52",
            "launches": launches["lane_contract"],
            "max_abs_err": errs["lane_contract"], **nums}


# the probe kernels' sources, and the TPU kernel each bisect stage replaces
# (bisect2's five all come from its make_stage)
PROBE_TRANSPOSED_SOURCE = "frizbee_tpu_torch/csrc/probe_transposed.cu"
PROBE_BISECT_SOURCE = "frizbee_tpu_torch/csrc/probe_colstream_bisect.cu"
PROBE_BISECT_REPLACES = {
    "a_simple+outs": "benchmarks/probe_colstream_bisect.py:63",
    "b_full_sw": "benchmarks/probe_colstream_bisect.py:88",
    "c_pf_t0": "benchmarks/probe_colstream_bisect.py:173",
    "c1_no_advance": "benchmarks/probe_colstream_bisect.py:236",
    "c2_only_advance": "benchmarks/probe_colstream_bisect.py:272",
}


def _probe_records(label, records):
    """A probe's records, each printed; fails at the first whose check
    (``ok``, ``correct``, ``*_equal``) is false."""
    out = []
    for rec in records:
        out.append(rec)
        print(f"probes phase, {label}: " + json.dumps(rec), flush=True)
        bad = [k for k, v in rec.items() if v is False
               and (k in ("ok", "correct") or k.endswith("_equal"))]
        assert not bad, f"probe {label} failed its check: {rec}"
    return out


def probes_phase(dev, errs, detail):
    """The reference's kernel probes on the card, each a path of its own
    (every launch counter set to 0 just before, read just after): the
    broad top-k tournament at R 64 and 128 against the full sort and
    ``torch.topk`` with the gather timed alone, the transposed
    recurrence's check and its comparison with the row-major kernel, and
    every colstream bisect stage (with the whole colstream kernel) at the
    reference's 2048 rows and again timed at 1M rows. Each probe's own
    checks must pass. Then each probe kernel, on that probe's inputs, is
    held bit-equal to its plain version and timed beside its bound and
    plain version: the transposed kernel at the check's timing shape and
    the comparison's largest, each bisect stage at 1M rows, the row
    gather of the tournament's timing (beside ``torch.index_select``).
    Returns the ``kernels`` entries."""
    from collections import Counter
    from itertools import chain

    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.probes import broad_topk
    from frizbee_tpu_torch.probes import colstream_bisect as pb
    from frizbee_tpu_torch.probes import transposed as pt

    groups = PROBE_BISECT_ROWS // pb.GROUP_ROWS
    paths = {
        "broad_topk": lambda: broad_topk.run(dev),
        "transposed_check": lambda: pt.check(dev),
        "transposed_compare": lambda: pt.compare(dev),
        "colstream_bisect": lambda: chain(
            pb.run(dev), pb.run(dev, groups=groups, timed=True)),
    }
    records, launches = {}, {}
    stage_launches = Counter()
    for label, fn in paths.items():
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        # the bisect stages share one launch counter: the capture tells
        # them apart
        _build.CAPTURE = [] if label == "colstream_bisect" else None
        try:
            records[label] = _probe_records(label, fn())
            torch.cuda.synchronize()
        finally:
            captured, _build.CAPTURE = _build.CAPTURE, None
        launches[label] = dict(_build.LAUNCHES)
        if label == "colstream_bisect":
            stage_launches.update(a[0] for name, (a, _kw) in captured
                                  if name == "probe_colstream_bisect")
        del captured
    assert launches["broad_topk"]["row_gather"] > 0, launches
    for label in ("transposed_check", "transposed_compare"):
        assert launches[label]["probe_transposed"] > 0, launches
    assert launches["transposed_compare"]["match_units"] > 0, launches
    bis = launches["colstream_bisect"]
    assert bis["colstream_fuzzy"] > 0, bis
    assert sum(stage_launches.values()) == bis["probe_colstream_bisect"]
    assert all(stage_launches[s] > 0 for s in pb.STAGES), stage_launches
    detail["probes"] = {"records": records, "launches": launches,
                        "bisect_stage_launches": dict(stage_launches)}

    entries = []
    ab_cases = {}

    def entry(name, kernel, calls, source, replaces, n_launches):
        errs.setdefault(name, 0.0)
        if kernel != "row_gather":
            ab_cases[name] = (kernel, calls)
        nums, work = _replay(name, kernel, calls, errs)
        detail.setdefault("timing", {})[name] = {**nums, **work}
        print(f"probes phase: {name} " + json.dumps(detail["timing"][name]),
              flush=True)
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n_launches,
                        "max_abs_err": errs[name], **nums})

    needle, _hay, lin = pt.check_inputs(dev)
    entry("probe_transposed", "probe_transposed",
          [((pt.to_blocks(lin), pt.needle_scalars(needle, lin.shape[0], dev)),
            dict(W=lin.shape[1], n=pt.N))],
          PROBE_TRANSPOSED_SOURCE, "benchmarks/probe_transposed_check.py:96",
          launches["transposed_check"]["probe_transposed"])
    del lin
    *_, (needle, hay) = pt.compare_inputs(dev)
    entry("probe_transposed_compare", "probe_transposed",
          [((pt.to_blocks(hay), pt.needle_scalars(needle, hay.shape[0], dev)),
            dict(W=hay.shape[1], n=pt.N))],
          PROBE_TRANSPOSED_SOURCE, "benchmarks/probe_transposed.py:95",
          launches["transposed_compare"]["probe_transposed"])
    del hay
    cpT, nuT, scal = pb.to_colstream(*pb.bisect_inputs(groups), dev)
    for stage in pb.STAGES:
        entry(f"probe_bisect_{stage}", "probe_colstream_bisect",
              [((stage, cpT, nuT, scal), dict(W=pb.W, n=pb.N))],
              PROBE_BISECT_SOURCE,
              PROBE_BISECT_REPLACES.get(
                  stage, "benchmarks/probe_colstream_bisect2.py:57"),
              stage_launches[stage])
    del cpT, nuT, scal
    entry("row_gather_broad_topk", "row_gather",
          [(broad_topk.gather_args(dev), {})],
          "frizbee_tpu_torch/csrc/row_gather.cu",
          "benchmarks/probe_broad_topk.py:93",
          launches["broad_topk"]["row_gather"])
    _probe_edge_checks(dev, errs, detail)
    probe_ab_phase(ab_cases, detail)
    _probe_build_reports(detail)
    return entries


# the transposed kernel's edge shapes: (n, W, rows, units in [lo, hi),
# needle units outside the hit table's [0, 256)): needles of 1 and 16
# units, widths that are no multiple of the ring's 8-column chunk (24 is
# three chunks; 13 and 20 end in a partial one), one 4096-row block (8
# tiles of 512 rows), and units and needles outside the table (its
# computed path) against a mixed needle
PROBE_TRANSPOSED_EDGES = (
    (1, 64, 8192, 97, 123, False), (16, 64, 8192, 97, 123, False),
    (8, 24, 8192, 97, 123, False), (8, 13, 8192, 97, 123, False),
    (8, 128, 4096, 97, 123, False), (5, 20, 8192, -300, 400, True),
    (16, 9, 4096, -3, 300, False),
)
# the bisect stages' edge inputs: (n, W, rows, units in [lo, hi), unit
# counts in [lo, hi], needle units outside the table): the reference's
# shape and units at n = 16; bytes 32-126 (upper case, digits and
# delimiters, so stage B takes every bonus class) at n = 16; and units,
# needles and counts outside their ranges at a width of a partial chunk
PROBE_BISECT_EDGES = (
    (16, 64, 2048, 97, 103, 0, 64, False),
    (16, 64, 2048, 32, 127, 0, 64, False),
    (5, 20, 2048, -300, 400, -2, 23, True),
)


def _probe_edge_checks(dev, errs, detail):
    """Each redesigned probe kernel held bit-equal to its plain version at
    the shapes its ring and tables make risky (PROBE_TRANSPOSED_EDGES,
    PROBE_BISECT_EDGES), inputs from a seed; every bisect stage at each.
    Mismatches fold into the kernels line's max_abs_err."""
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars
    from frizbee_tpu_torch.probes import colstream_bisect as pb
    from frizbee_tpu_torch.probes import transposed as pt

    rng = np.random.default_rng(15)
    cases = []
    errs.setdefault("probe_transposed", 0.0)
    for stage in pb.STAGES:
        errs.setdefault(f"probe_bisect_{stage}", 0.0)
    for n, W, B, lo, hi, big in PROBE_TRANSPOSED_EDGES:
        hay = rng.integers(lo, hi, (B, W)).astype(np.int32)
        needle = rng.integers(97, 103, n).astype(np.int32)
        if big:
            needle[0], needle[-1] = 300, -2
            hay[:64] = 300
        cpT = pt.to_blocks(torch.from_numpy(hay).to(dev))
        scal = pt.needle_scalars(needle, B, dev)
        got = pt.transposed_best(cpT, scal, W=W, n=n)
        want = pt.transposed_best_plain(cpT, scal, W=W, n=n)
        _check_equal(errs, "probe_transposed", got, want,
                     f"edge n={n} W={W} rows={B}")
        cases.append({"kernel": "probe_transposed", "n": n, "W": W,
                      "rows": B, "best_max": int(want.max())})
    for n, W, B, lo, hi, nlo, nhi, big in PROBE_BISECT_EDGES:
        cp = rng.integers(lo, hi, (B, W)).astype(np.int32)
        nu = rng.integers(nlo, nhi + 1, B).astype(np.int32)
        needle = rng.integers(97, 103, n).astype(np.int32)
        if big:
            needle[1] = 300
            cp[:64, :5] = 300
        cp[5, :min(n, W)], nu[5] = needle[:W], n  # an exact row
        scal = pack_needle_scalars(
            torch.from_numpy(np.concatenate([needle, needle - 32])), B)
        cp_t = torch.from_numpy(cp).to(dev)
        cpT = (cp_t.reshape(B // pb.GROUP_ROWS, pb.SUBL, 128, W)
               .permute(0, 3, 1, 2).reshape(-1, pb.SUBL, 128).contiguous())
        nuT = torch.from_numpy(nu).to(dev).reshape(-1, 128)
        scal = scal.to(dev)
        for stage in pb.STAGES:
            got = pb.bisect_stage(stage, cpT, nuT, scal, W=W, n=n)
            want = pb.bisect_stage_plain(stage, cpT, nuT, scal, W=W, n=n)
            _check_equal(errs, f"probe_bisect_{stage}", got, want,
                         f"edge n={n} W={W} rows={B}")
        cases.append({"kernel": "probe_colstream_bisect", "n": n, "W": W,
                      "rows": B, "units": [lo, hi], "stages": len(pb.STAGES)})
    torch.cuda.synchronize()
    detail.setdefault("probes", {})["edge_checks"] = cases
    print(f"probes phase: {len(cases)} edge inputs bit-equal "
          f"({sum(c.get('stages', 1) for c in cases)} launches)", flush=True)


# the C entry points of the probe kernels' first designs, which only the
# A/B below calls
PROBE_V1_ENTRIES = {"probe_transposed": "probe_transposed_v1_launch",
                    "probe_colstream_bisect": "probe_colstream_bisect_v1_launch"}


def _probe_v1(kernel, args, kw):
    """The first design of probe kernel ``kernel`` on its wrapper's
    arguments: the same output, from the ``v1`` C entry point (never
    counted in ``_build.LAUNCHES``)."""
    from frizbee_tpu_torch.ops import _build
    from frizbee_tpu_torch.probes import colstream_bisect as pb

    fn = getattr(_build.library(kernel), PROBE_V1_ENTRIES[kernel])
    fn.argtypes, fn.restype = _build.SIGNATURES[kernel][1], ctypes.c_int
    W, n = kw["W"], kw["n"]
    if kernel == "probe_transposed":
        cpT, scal = args
        nB = cpT.shape[0] // W
        out = torch.empty((nB * 32, 128), dtype=torch.int32,
                          device=cpT.device)
        call = (_build.ptr(cpT), _build.ptr(scal), _build.ptr(out), nB, W, n)
    else:
        stage, cpT, nuT, scal = args
        nG = cpT.shape[0] // W
        out = torch.empty((5, nG * pb.SUBL, 128), dtype=torch.int32,
                          device=cpT.device)
        call = (_build.ptr(cpT), _build.ptr(nuT), _build.ptr(scal),
                _build.ptr(out), nG, W, n, pb.STAGES.index(stage))
    with torch.cuda.device(cpT.device):
        rc = fn(*call, _build.stream(cpT))
    if rc != 0:
        raise RuntimeError(f"{kernel} v1 launch failed: CUDA error {rc}")
    return out


def probe_ab_phase(cases, detail):
    """The ring design of each redesigned probe kernel against its first
    design on the probes phase's own timed launches (``cases``: entry ->
    (kernel, [(args, kwargs)])): both held bit-equal first, then timed in
    AB_ROUNDS rounds that alternate which goes first. Medians, the share
    of rounds the ring design was faster, and the bound both share."""
    from frizbee_tpu_torch.probes import colstream_bisect as pb
    from frizbee_tpu_torch.probes import device_ms
    from frizbee_tpu_torch.probes import transposed as pt

    wrappers = {"probe_transposed": (pt.transposed_best, _transposed_work),
                "probe_colstream_bisect": (pb.bisect_stage, _bisect_work)}
    out = {}
    for label, (kernel, calls) in cases.items():
        wrapper, work = wrappers[kernel]
        designs = {"ring": lambda: [wrapper(*a, **kw) for a, kw in calls],
                   "v1": lambda: [_probe_v1(kernel, a, kw) for a, kw in calls]}
        new, old = designs["ring"](), designs["v1"]()
        torch.cuda.synchronize()
        for x, y in zip(new, old):
            assert torch.equal(x, y), f"{label}: ring design != first design"
        ops = in_b = out_b = 0.0
        for (a, kw), res in zip(calls, new):
            o, i, w = work(a, kw, res)
            ops, in_b, out_b = ops + o, in_b + i, out_b + w
        del new, old
        bound_ms, bound_by = _bound(in_b, out_b, ops)
        ms = {"v1": [], "ring": []}
        for r in range(AB_ROUNDS):
            for v in (("v1", "ring") if r % 2 == 0 else ("ring", "v1")):
                ms[v].append(device_ms(designs[v]))
        med = {v: float(np.median(t)) for v, t in ms.items()}
        out[label] = {
            "launches": len(calls), "ms": ms, "median_ms": med,
            "ring_won_share": float(np.mean(
                np.array(ms["ring"]) < np.array(ms["v1"]))),
            "ring_over_v1": med["ring"] / med["v1"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": {v: bound_ms / m for v, m in med.items()},
        }
        print(f"probe ring/v1 A/B, {label}: " + json.dumps(
            {k: v for k, v in out[label].items() if k != "ms"}), flush=True)
    detail["probe_ab"] = out
    return out


# kernels whose ptxas report and static SASS mix the probes phase keeps:
# the ring designs at n 8 and 16 (stage id first for the bisect), the PR
# 7 designs at n 8
PROBE_REPORT_KERNELS = re.compile(
    r"(probe_transposed_ring_kernel|probe_transposed_kernel|"
    r"probe_colstream_bisect_ring_kernel|probe_colstream_bisect_kernel)"
    r"ILi(\d+)E(?:Li(\d+)E)?")
# SASS opcodes by the pipe that runs them (Hopper): DPX (VIADDMNMX,
# VIMNMX3, VIMNMX) and PRMT, which share one pipe of 64 lanes an SM a
# clock (pipe_rates.py), the rest of the integer ALU, the FMA pipe's
# integer forms, shared and global memory (UBLKCP: a TMA bulk copy), and
# the rest (branches, barriers and mbarrier waits, moves of special
# registers)
SASS_PIPES = (
    ("dpx_prmt", ("VIADDMNMX", "VIMNMX3", "VIMNMX", "VIBMNMX", "PRMT")),
    ("alu", ("IADD3", "LOP3", "ISETP", "SEL", "SHF", "IMNMX", "VIADD",
             "LEA", "IABS", "FLO", "POPC", "BREV", "PLOP3", "P2R", "R2P",
             "SGXT", "BMSK", "ICMP", "VABSDIFF", "VABSDIFF4", "LOP")),
    ("fma", ("IMAD", "FFMA", "FADD", "FMUL", "IDP", "IMUL")),
    ("shared", ("LDS", "STS", "LDSM", "ATOMS")),
    ("global", ("LDG", "STG", "LDGSTS", "UBLKCP", "LD", "ST", "RED",
                "ATOMG", "LDGDEPBAR", "DEPBAR")),
)


def _probe_name(m):
    """('transposed'|'bisect', design, stage or None, n) of a report
    kernel's mangled name match."""
    fn, a, b = m.group(1), int(m.group(2)), m.group(3)
    design = "ring" if "ring" in fn else "v1"
    if "transposed" in fn:
        return "transposed", design, None, a
    return "bisect", design, a, int(b)


def _probe_report_key(m):
    """The report key of a mangled name match, or None for a kernel the
    reports skip (the ring designs are kept at n 8 and 16, the first
    designs at n 8)."""
    if m is None:
        return None
    kind, design, stage, n = _probe_name(m)
    if n not in ((8, 16) if design == "ring" else (8,)):
        return None
    from frizbee_tpu_torch.probes import colstream_bisect as pb
    what = "" if stage is None else pb.STAGES[stage] + " "
    return f"{kind} {design} {what}n={n}"


def _probe_build_reports(detail):
    """The ptxas report (registers, spill bytes, shared memory) of the
    probe kernels' ring designs at n 8 and 16 and first designs at n 8,
    from the build's log, and the static SASS opcode mix of each
    (``cuobjdump -sass`` of the built library, opcodes counted by pipe)."""
    from frizbee_tpu_torch.ops import _build

    ptxas = {}
    for lib in ("probe_transposed", "probe_colstream_bisect"):
        log = detail.get("build", {}).get(lib, {}).get("ptxas", "")
        for name, rec in _ptxas_kernels(log).items():
            key = _probe_report_key(PROBE_REPORT_KERNELS.search(name))
            if key is not None:
                ptxas.setdefault(key, {}).update(rec)
    sass = {}
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    for lib in ("probe_transposed", "probe_colstream_bisect"):
        if not os.path.exists(cuobjdump):
            sass["error"] = "cuobjdump not found"
            break
        text = subprocess.run([cuobjdump, "-sass", _build._lib_path(lib)],
                              capture_output=True, text=True).stdout
        cur = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = _probe_report_key(
                    PROBE_REPORT_KERNELS.search(m.group(1)))
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
            if cur is None or not m:
                continue
            op = m.group(1)
            pipe = next((p for p, ops in SASS_PIPES if op in ops), "other")
            rec = sass.setdefault(cur, {"total": 0, "pipes": {},
                                        "opcodes": {}})
            rec["total"] += 1
            rec["pipes"][pipe] = rec["pipes"].get(pipe, 0) + 1
            rec["opcodes"][op] = rec["opcodes"].get(op, 0) + 1
    detail.setdefault("probes", {})["ptxas"] = ptxas
    detail["probes"]["sass"] = sass
    print("probes phase, ptxas: " + json.dumps(ptxas), flush=True)
    print("probes phase, SASS pipes: " + json.dumps(
        {k: v["pipes"] if isinstance(v, dict) else v
         for k, v in sass.items()}), flush=True)


def _greedy_rows(n, seed=7):
    """Arabic rows of 600-1000 codepoints (1200-2000 UTF-8 bytes) from
    the script's letters and spaces: bucketed (at most 1024 units) but
    wider than the 1024-byte DP cap, so a match's trimmed window is
    greedy-flagged on the device and rescored on the host."""
    rng = np.random.default_rng(seed)
    letters = np.array([chr(c) for c in range(0x0621, 0x064B)] + [" "])
    return ["".join(rng.choice(letters, size=int(rng.integers(600, 1001))))
            for _ in range(n)]


def cpu_parity_phase(detail):
    """Reduced size: the card's serving arrays equal the CPU's, group by
    group, and so do the decoded top-k results — byte corpora, Arabic and
    Korean codepoint corpora, ASCII needles under ALWAYS over a
    mixed-script codepoint corpus, multi-pattern and negated queries, a
    byte corpus with XL rows (wider than the widest bucket: the host
    fixups and their presence gate) and an Arabic one with greedy-flagged
    rows (rescored on the host)."""
    from frizbee_tpu_torch import Config, UnicodeMatching, datagen
    from frizbee_tpu_torch import match_topk_batch, pack_corpus
    from frizbee_tpu_torch.config import Scoring
    from frizbee_tpu_torch.matcher import Matcher, _dispatch_batch_groups

    n_rows, q = 20_000, 8
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=n_rows, seed=7)
    long_hay = _long_corpus(n_rows, seed=7)
    xl_hay = hay + datagen.xl_heavy_corpus(num_samples=64, seed=7)
    multi = _multi_queries(q) + ["!dead !beef"]
    cases = [
        ("fuzzy T=0", hay, _queries(q), Config(max_typos=0)),
        ("fuzzy T=1", hay, _queries(q), Config(max_typos=1)),
        ("literal", hay, _literal_queries(q), Config()),
        (f"typo T={TYPO_BUDGET}", hay, _queries(q),
         Config(max_typos=TYPO_BUDGET)),
        ("long needle", long_hay, _queries(q, LONG_NEEDLE), Config()),
        (f"typo T={TYPO_BUDGET} wide scores", hay, _queries(q),
         Config(max_typos=TYPO_BUDGET, scoring=Scoring(**WIDE_SCORING))),
        ("multi T=0", hay, multi, Config(max_typos=0)),
        ("multi T=1", hay, multi, Config(max_typos=1)),
        # XL rows: the host fixups add the XL candidates that match
        ("XL rows, fuzzy T=0", xl_hay, _queries(q), Config(max_typos=0)),
        ("XL rows, fuzzy T=1", xl_hay, _queries(q), Config(max_typos=1)),
        # the XL rows hold the needle's letters apart, never two in a
        # row: one-byte substrings match them
        ("XL rows, literal", xl_hay, [f"'{c}" for c in "deabfDEF"],
         Config()),
        ("XL rows, multi", xl_hay, _multi_queries(4), Config()),
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
    arabic = _unicode_corpus(n_rows, "arabic", seed=7)
    cases.append(("arabic multi", arabic, _unicode_multi_queries(q),
                  Config(), True, True))
    # greedy rows: eight-codepoint needles keep every count within k (a
    # greedy-risk corpus past k needs the full-fetch fallback)
    greedy_hay = arabic + _greedy_rows(32)
    cases += [
        ("arabic greedy rows, fuzzy", greedy_hay,
         _unicode_queries(q, kind=4), Config(max_typos=1), True, True),
        ("arabic greedy rows, multi", greedy_hay,
         [p[:4] + " " + p[4:] for p in _unicode_queries(q, kind=4)],
         Config(max_typos=0), True, True),
    ]
    mixed = _unicode_corpus(n_rows // 2, seed=8) + hay[:n_rows // 2]
    cases.append(("ALWAYS ascii needles, mixed script", mixed, _queries(q),
                  Config(unicode=UnicodeMatching.ALWAYS), True, True))
    packed = {}
    compared = {}
    seconds = {}
    for label, rows, queries, cfg, *uni in cases:
        t0 = time.perf_counter()
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
        if label.startswith("XL"):
            # the host fixups added matching XL rows to the device count
            dev_count = {i: int(a[j, 0, 0]) for a, m in raw[0]
                         for j, i in enumerate(m)}
            assert any(x[0] > dev_count[i] for i, x in enumerate(got)), (
                f"{label}: no XL row served")
        if "greedy" in label:
            flagged = 0
            for a, _m in raw[0]:
                for blk in a:
                    rows = blk[1:1 + min(int(blk[0, 0]), len(blk) - 1)]
                    flagged += int(((rows[:, 1].view(np.uint32) >> 14)
                                    & 1).sum())
            assert flagged > 0, f"{label}: no greedy-flagged row"
            detail.setdefault("cpu_parity_greedy_rows", {})[label] = flagged
        compared[label] = sum(a.size for a, _m in raw[0])
        seconds[label] = time.perf_counter() - t0
    detail["cpu_parity_elements"] = compared
    detail["cpu_parity_seconds"] = seconds
    print(f"card-vs-CPU phase: serving-array elements equal "
          f"({n_rows} rows, Q={q}): {json.dumps(compared)}", flush=True)


# match_iter's card-versus-CPU input: four chunks of the default
# iter_chunk (65,536 rows), a reduced size of the 1M-row corpus
ITER_ROWS = 262_144


def single_cpu_parity_phase(detail):
    """Reduced size (20k rows; match_iter at ITER_ROWS): the single-query
    API on the card equals the port on the CPU — ``match_list`` and
    ``match_iter`` over strings, ``match_list_parallel(shards=4)``,
    ``match_arrays_batch`` at Q=32, the empty query, an ASCII needle over
    an Arabic-packed corpus (the repack), and a greedy-risk corpus past k
    through ``match_topk_batch`` (the full-fetch fallback),
    ``match_list_indices`` of every SINGLE_QUERIES query (whole lists);
    then a corpus that a Matcher's dispatch cache holds is dropped and
    device memory returns to its level before the pack."""
    import gc

    from frizbee_tpu_torch import (
        Config,
        Matcher,
        datagen,
        fuzzy_match,
        match_arrays_batch,
        match_list,
        match_topk_batch,
        pack_corpus,
    )

    n_rows = 20_000
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=n_rows, seed=7)
    seconds = {}

    def same(label, got, want, must_match=True):
        assert len(got) == len(want), label
        for a, b in zip(got, want):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), f"card != CPU: {label}"
            else:
                assert a == b, f"card != CPU: {label}"
        assert not must_match or len(got[0]) > 0, f"{label}: no match"

    def rows(ms):
        return [(m.score, m.index, m.exact, m.end_col) for m in ms]

    t0 = time.perf_counter()
    for q in ("deadbeef", "dead !^beef", "'dead"):
        got = Matcher.from_query(q).match_list(hay)
        want = Matcher.from_query(q, device="cpu").match_list(hay)
        same(f"match_list {q}", got.arrays(), want.arrays())
    assert match_list("deadbeef", hay) == match_list("deadbeef", hay,
                                                     device="cpu")
    seconds["match_list"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    iter_hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                            num_samples=ITER_ROWS, seed=8)
    card, cpu = Matcher.from_query("deadbeef"), Matcher.from_query(
        "deadbeef", device="cpu")
    assert card.iter_chunk == 65536
    got = rows(card.match_iter(iter_hay))
    assert got and got == rows(cpu.match_iter(iter_hay)), "match_iter"
    assert rows(fuzzy_match(iter(hay), "deadbeef")) == rows(
        fuzzy_match(iter(hay), "deadbeef", device="cpu")), "fuzzy_match"
    seconds["match_iter"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    got = Matcher.from_query("deadbeef").match_list_parallel(hay, 4)
    want = Matcher.from_query("deadbeef", device="cpu").match_list_parallel(
        hay, 4)
    assert got and rows(got) == rows(want), "match_list_parallel"
    seconds["match_list_parallel"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    on_card, on_cpu = pack_corpus(hay), pack_corpus(hay, device="cpu")
    queries = _queries(Q)
    for i, (g, w) in enumerate(zip(match_arrays_batch(queries, on_card),
                                   match_arrays_batch(queries, on_cpu))):
        same(f"match_arrays_batch {queries[i]}", g, w, i == 0)
    seconds["match_arrays_batch"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    same("empty query", Matcher.from_query("").match_arrays(on_card),
         Matcher.from_query("").match_arrays(on_cpu))
    for g, w in zip(match_topk_batch(["", "deadbeef"], on_card, k=TOP_K),
                    match_topk_batch(["", "deadbeef"], on_cpu, k=TOP_K)):
        same("empty query, match_topk_batch", g[1:], w[1:])
        assert g[0] == w[0]
    seconds["empty"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    arabic = _unicode_corpus(n_rows, "arabic", seed=7)
    mixed = arabic[: n_rows // 2] + hay[: n_rows // 2]
    ucard = pack_corpus(mixed, unicode=True)
    ucpu = pack_corpus(mixed, unicode=True, device="cpu")
    same("ASCII needle over the Arabic-packed corpus",
         Matcher.from_query("deadbeef").match_arrays(ucard),
         Matcher.from_query("deadbeef").match_arrays(ucpu))
    seconds["repack"] = time.perf_counter() - t0

    # match_list_indices of every SINGLE_QUERIES query: the whole lists;
    # the 20k rows hold no "dead" prefix, so 64 rows gain one for "^dead"
    t0 = time.perf_counter()
    rows_of = {"ascii": hay + ["dead" + h for h in hay[:64]],
               "long": _long_corpus(n_rows, seed=7), "arabic": arabic}
    packed = {key: (pack_corpus(r, unicode=key == "arabic"),
                    pack_corpus(r, unicode=key == "arabic", device="cpu"))
              for key, r in rows_of.items()}
    counts = {}
    for label, key, q, cfg, _k in SINGLE_QUERIES:
        card, cpu = packed[key]
        got = _indices_rows(Matcher.from_query(
            q, Config(**cfg)).match_list_indices(card))
        want = _indices_rows(Matcher.from_query(
            q, Config(**cfg), device="cpu").match_list_indices(cpu))
        assert got and got == want, f"card != CPU: match_list_indices {label}"
        counts[label] = len(got)
    del packed, rows_of
    detail["single_cpu_parity_indices_counts"] = counts
    seconds["match_list_indices"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    greedy_hay = arabic + _greedy_rows(32)
    gcard = pack_corpus(greedy_hay, unicode=True)
    gcpu = pack_corpus(greedy_hay, unicode=True, device="cpu")
    assert gcard.greedy_risk()
    needle, k = UNICODE_NEEDLE["arabic"], 64
    got = match_topk_batch([needle], gcard, Config(), k=k)[0]
    want = match_topk_batch([needle], gcpu, Config(), k=k)[0]
    assert got[0] > k, f"greedy-risk count {got[0]} within k"
    assert got[0] == want[0]
    same("greedy-risk corpus past k", got[1:], want[1:])
    seconds["greedy_full_fetch"] = time.perf_counter() - t0

    # a corpus the dispatch cache holds: dropping it frees its tensors
    del on_card, ucard, gcard
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    corpus = pack_corpus(hay)
    m = Matcher.from_query("deadbeef")
    m.match_arrays(corpus)
    packed = torch.cuda.memory_allocated()
    assert m._dispatch_cache and packed > base
    del corpus
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert not m._dispatch_cache, "dispatch cache kept a dropped corpus"
    assert after == base, f"device memory {base} -> {after} after eviction"
    detail["single_memory_bytes"] = {"before_pack": base, "packed": packed,
                                     "after_drop": after}
    detail["single_cpu_parity_seconds_20k"] = seconds
    print(f"single card-vs-CPU phase: equal ({json.dumps(seconds)}); "
          f"device memory {base} -> {packed} -> {after} bytes", flush=True)


# The watchdog: every phase of the main process, every side process and
# the late build thread has a budget in seconds. At WATCH_SHARE of it a
# watchdog thread prints every thread's Python stack (faulthandler) and,
# from /proc, each task's state and CPU ticks in this process, its child
# processes and the side processes; at the whole budget it prints them
# again and ends the run: the side processes' logs are echoed and the
# processes killed, exit 1, no result line. The dumps come from a Python
# thread, which holds the GIL while it dumps, so no thread moves under it
# (faulthandler.dump_traceback_later's C timer, which dumps without the
# GIL, segfaulted a process on the card's machine). A stall that holds the
# GIL is left to the run's own time limit.
WATCH_SHARE = 0.5
# at least three times each phase's longest time in the runs PERF.md
# records (kernel 271 s, indices 108, timing 69-109), never under 120 s
PHASE_BUDGETS = {
    "build": 300, "corpora": 300, "kernel": 800, "unicode_corpus": 300,
    "kernel_unicode": 300,
    "contract": 120, "cpu_parity_wait": 400, "serving": 300, "single": 300,
    "indices": 400, "generic": 300, "native": 300, "parallel": 300,
    "timing": 400, "late_build_wait": 300, "probes": 300, "profile": 300,
}
LATE_BUILD_BUDGET = 400  # the bisect library's nvcc, beside the phases


def _proc_read(path):
    """The text of a /proc file, or None where it cannot be read."""
    try:
        with open(path) as fh:
            return fh.read().strip()
    except OSError:
        return None


def _task_states(pid, indent="  "):
    """Lines on process ``pid`` from /proc: a line per task (its name,
    state and user and system CPU ticks), then each child process's
    (``task/*/children``), indented below it."""
    try:
        tids = sorted(os.listdir(f"/proc/{pid}/task"), key=int)
    except OSError as e:
        return [f"{indent}{e.strerror}"]
    lines = []
    children = []
    for tid in tids:
        base = f"/proc/{pid}/task/{tid}"
        stat = _proc_read(f"{base}/stat")
        if stat is None:  # the task ended
            continue
        f = stat[stat.rindex(")") + 2:].split()
        lines.append(f"{indent}  task {tid} "
                     f"{stat[stat.index('(') + 1:stat.rindex(')')]} {f[0]} "
                     f"utime {f[11]} stime {f[12]}")
        children += (_proc_read(f"{base}/children") or "").split()
    for child in children:
        lines.append(f"{indent}process {child}:")
        lines += _task_states(int(child), indent + "  ")
    return lines


class _Watchdog:
    """A daemon thread over watched items, each a label, a budget in
    seconds and, for a side process or thread, an ``alive`` test (it is
    dropped once that fails) and the process id. At WATCH_SHARE of an
    item's budget it prints the stacks and task states; at the whole
    budget it prints them again and the overrun, calls ``on_fail`` and
    ends the process with exit code 1 (a main thread that ``on_fail``
    wakes may end it first, also with exit code 1)."""

    def __init__(self, on_fail=None):
        self._items = {}
        self._lock = threading.Lock()
        self._on_fail = on_fail
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="watchdog",
                                        daemon=True)
        self._thread.start()

    def add(self, label, budget, alive=None, pid=None):
        with self._lock:
            self._items[label] = [time.perf_counter(), budget, alive, pid,
                                  False]

    def drop(self, label):
        with self._lock:
            self._items.pop(label, None)

    def watch(self, label, budget):
        """A context manager that watches its body as ``label``."""
        import contextlib

        @contextlib.contextmanager
        def body():
            self.add(label, budget)
            try:
                yield
            finally:
                self.drop(label)
        return body()

    def close(self):
        self._stop.set()
        self._thread.join()

    def dump(self, why):
        """Every thread's stack, then the task states of this process and
        of every watched process."""
        import faulthandler

        with self._lock:
            pids = [item[3] for item in self._items.values()
                    if item[3] is not None]
        sys.stdout.flush()
        print(f"watchdog: {why}; every thread's stack:", flush=True)
        faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
        for pid in (os.getpid(), *pids):
            print(f"watchdog: tasks of process {pid}:\n"
                  + "\n".join(_task_states(pid)), flush=True)

    def _loop(self):
        while not self._stop.wait(1.0):
            now = time.perf_counter()
            with self._lock:
                items = list(self._items.items())
            for label, item in items:
                t0, budget, alive, _, shared = item
                if alive is not None and not alive():
                    self.drop(label)
                    continue
                if now - t0 >= budget:
                    self.dump(f"{label} overran its budget of {budget} s")
                    print(f"chip_smoke: {label} still running after "
                          f"{now - t0:.1f} s, past its budget of {budget} "
                          f"s", file=sys.stderr, flush=True)
                    if self._on_fail is not None:
                        self._on_fail()
                    os._exit(1)
                if not shared and now - t0 >= WATCH_SHARE * budget:
                    item[4] = True
                    self.dump(f"{label} still running at {now - t0:.1f} s "
                              f"of its budget of {budget} s")


def _die_with_parent():
    """Have the kernel kill this process when the thread that started it
    ends (PR_SET_PDEATHSIG), so a side process never outlives a run that
    ended without stopping it (at the run's time limit, say)."""
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL, 0, 0, 0)  # PR_SET_PDEATHSIG


# Work that runs beside the main phases, each in a process of its own on
# the same card: the Arabic corpus's generation, the kernels' boundary
# checks (small shapes whose plain versions are bound by the host's
# launches) and the card-versus-CPU phases (bound by the port's CPU
# path). Each is joined before any phase that times the card or the host.
SIDE_TIMEOUT = 900  # seconds from a side process's start to its exit
SIDE_CPU_THREADS = 4  # torch and OpenMP threads of the card-vs-CPU process
# the kernel phase's boundary checks, in the order of its summary line
BOUNDARY_CHECKS = ("match_units", "tile", "pairing")
CPU_PARITY_PHASES = ("cpu_parity", "single_cpu_parity", "generic_cpu_parity")


class _Side:
    """``chip_smoke.<name>(out_path)`` run with ``python -c`` from the
    checkout's root (through ``_side_main``), its output in a log, watched
    by ``watchdog`` with SIDE_TIMEOUT as its budget (the watchdog ends the
    run if it is still running then). ``join`` waits for it, echoes the
    log, raises unless the process exited 0, and returns the JSON the
    process wrote to ``out_path`` with the seconds the caller waited;
    ``stop`` kills it if it still runs."""

    # the process's program, run as ``python -c CODE out_path``
    CODE = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke._side_main({name!r}, sys.argv[1]))")

    def __init__(self, name, tmp, watchdog, threads=None):
        self.name = name
        self.out = os.path.join(tmp, name + ".json")
        self.log = open(os.path.join(tmp, name + ".log"), "w+",
                        encoding="utf-8")
        env = dict(os.environ)
        if threads:
            env["OMP_NUM_THREADS"] = str(threads)
        code = self.CODE.format(name=name)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, self.out], cwd=ROOT,
            stdout=self.log, stderr=subprocess.STDOUT, env=env)
        self.watchdog = watchdog
        watchdog.add(f"side process {name}", SIDE_TIMEOUT,
                     alive=lambda: self.proc.poll() is None,
                     pid=self.proc.pid)

    def echo(self):
        """Print the log and close it: the watchdog's ``on_fail`` and
        ``join`` may both echo a side, and only the first prints."""
        if self.log.closed:
            return
        self.log.flush()
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        if text:
            print(text.rstrip("\n"), flush=True)

    def join(self):
        t0 = time.perf_counter()
        self.proc.wait()
        self.watchdog.drop(f"side process {self.name}")
        self.echo()
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"{self.name} exited {self.proc.returncode} after "
                f"{time.perf_counter() - self.t0:.1f} s")
        with open(self.out, encoding="utf-8") as fh:
            out = json.load(fh)
        out["wait_seconds"] = time.perf_counter() - t0
        return out

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class _Sides(dict):
    """The side processes started and not yet joined, by name: each stays
    here until its join returns, so a watchdog's ``on_fail`` (``stop``
    with ``echo``) echoes the log of the one being joined too."""

    def join(self, name):
        try:
            return self[name].join()
        finally:
            del self[name]

    def stop(self, echo=False):
        for side in list(self.values()):
            if echo:
                side.echo()
            side.stop()


def _side_main(name, out_path):
    """A side process's body: ``name``(out_path) under a watchdog of its
    own, which prints the side's stacks into its log at WATCH_SHARE of
    SIDE_TIMEOUT (the main process's watchdog ends the side at the whole
    budget, before this one would)."""
    _die_with_parent()
    watchdog = _Watchdog()
    try:
        with watchdog.watch(name, SIDE_TIMEOUT + 60):
            return globals()[name](out_path)
    finally:
        watchdog.close()


def _write_json(out_path, obj):
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, ensure_ascii=False)
    return 0


def _side_unicode_corpus(out_path):
    """The 1M-row Arabic corpus (``_unicode_corpus(N_ROWS)``, the same rows
    as in the main process) and the seconds its generation took."""
    t0 = time.perf_counter()
    rows = _unicode_corpus(N_ROWS)
    return _write_json(out_path, {"seconds": time.perf_counter() - t0,
                                  "rows": rows})


def _side_kernel_boundaries(out_path):
    """The kernel phase's checks at the row-major template boundaries, the
    colstream tile boundaries and the pairing boundaries, on the card:
    their counts, seconds and max_abs_err (a mismatch raises)."""
    dev = torch.device("cuda")
    errs = {entry[0]: 0.0 for entry in KERNELS}
    checks, seconds = {}, {}
    for label, fn in zip(BOUNDARY_CHECKS, (_rowmajor_boundary_checks,
                                           _tile_boundary_checks,
                                           _pairing_checks)):
        t0 = time.perf_counter()
        checks[label] = fn(dev, errs)
        seconds[label] = time.perf_counter() - t0
    return _write_json(out_path, {"checks": checks, "seconds": seconds,
                                  "errs": errs})


def _side_cpu_parity(out_path):
    """The card-versus-CPU phases (CPU_PARITY_PHASES) with SIDE_CPU_THREADS
    torch threads: their detail and each one's seconds."""
    torch.set_num_threads(SIDE_CPU_THREADS)
    detail, seconds = {}, {}
    for name in CPU_PARITY_PHASES:
        t0 = time.perf_counter()
        globals()[name + "_phase"](detail)
        seconds[name] = time.perf_counter() - t0
    detail["phase_seconds"] = seconds
    return _write_json(out_path, detail)


def native_build():
    """Build (or find built) the native host library and the fastmatch
    extension: the compilers' versions, each build's seconds (absent when
    it was already built), the OpenMP threads the library sees and the
    host CPU. Raises when either fails to build or load."""
    import platform

    from frizbee_tpu_torch import native

    native.get_fastmatch()
    threads = native.omp_threads()
    # the first processor's /proc/cpuinfo fields; where the host gives
    # no model name (or "unknown"), its vendor, family, model and
    # stepping name the CPU
    fields = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if not line.strip():
                if fields:
                    break
                continue
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    model = fields.get("model name", "unknown")
    if model in ("", "unknown"):
        model = " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                         "stepping") if k in fields
        ) or "not reported"
    return {
        "g++": subprocess.run(["g++", "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0],
        "gcc": subprocess.run(["gcc", "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0],
        "build_seconds": dict(native.BUILD_SECONDS),
        "build_dir": os.path.relpath(native.build_dir(), ROOT),
        "omp_threads": threads,
        "cpu_model": model, "cpu_machine": platform.machine(),
        "cpu_count": os.cpu_count(),
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tempfile

    sides = _Sides()
    watchdog = _Watchdog(on_fail=lambda: sides.stop(echo=True))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            return _run(tmp, sides, watchdog)
        finally:
            sides.stop()


def _run(tmp, sides, watchdog):
    """Every phase in order, each watched by ``watchdog`` with its budget
    (PHASE_BUDGETS); ``sides`` (a ``_Sides``) holds the side processes,
    which ``main`` stops if a phase raises."""
    import contextlib

    from frizbee_tpu_torch import datagen, pack_corpus
    from frizbee_tpu_torch.ops import _build

    t_start = time.perf_counter()
    phases = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        with watchdog.watch(f"phase {name}", PHASE_BUDGETS[name]):
            yield
        phases[name] = time.perf_counter() - t0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    detail = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    # the Arabic corpus generates beside the builds, the byte corpora and
    # the kernel phase
    sides["unicode"] = _Side("_side_unicode_corpus", tmp, watchdog)
    # the bisect probe's library (320 kernels, ~77 s of nvcc alone) builds
    # beside everything up to the probes phase, its nvcc started with the
    # others, before the native OpenMP pool exists
    late = {}
    late_build = threading.Thread(
        target=lambda: late.update(_build.build([LATE_BUILD])),
        name="late_build")
    late_build.start()
    watchdog.add("late build thread", LATE_BUILD_BUDGET,
                 alive=late_build.is_alive)
    with phase("build"):
        built = _build.build([k for k in _build.SIGNATURES
                              if k != LATE_BUILD])
    detail["build"] = {k: {"seconds": v["seconds"], "ptxas": v["log"]}
                       for k, v in built.items()}
    print(smi, flush=True)
    print(f"kernel build: {phases['build']:.1f} s ({len(built)} libraries, "
          f"nvcc in parallel; {LATE_BUILD} building on)", flush=True)
    detail["native_build"] = native_build()
    print("native build: " + json.dumps(detail["native_build"]), flush=True)
    # with the libraries built, the boundary checks and the card-vs-CPU
    # phases start beside the corpora and the kernel phases
    sides["boundaries"] = _Side("_side_kernel_boundaries", tmp, watchdog)
    sides["cpu_parity"] = _Side("_side_cpu_parity", tmp, watchdog,
                                threads=SIDE_CPU_THREADS)

    with phase("corpora"):
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
        detail["long_buckets"] = [(b.width, b.size)
                                  for b in long_corpus.buckets]
        print(f"long-needle corpus: {len(long_corpus)} rows, buckets "
              f"{detail['long_buckets']}, generated and packed in "
              f"{detail['long_pack_seconds']:.1f} s", flush=True)

    with phase("kernel"):
        errs = kernel_phase(corpus, detail,
                            lambda: sides.join("boundaries"))
    with phase("unicode_corpus"):
        # the Arabic corpus, generated beside the builds and the kernel
        # phase
        got = sides.join("unicode")
        uhay = got["rows"]
        detail["unicode_generate_seconds"] = got["seconds"]
        detail["unicode_generate_wait_seconds"] = got["wait_seconds"]
        del got
        t0 = time.perf_counter()
        ucorpus = pack_corpus(uhay, unicode=True)
        for b in ucorpus.buckets:
            b.device_arrays_colstream()
            b.device_presence_bits()
            b.device_arrays_units()
        torch.cuda.synchronize()
        detail["unicode_pack_seconds"] = time.perf_counter() - t0
        detail["unicode_buckets"] = [(b.width, b.size)
                                     for b in ucorpus.buckets]
        print(f"unicode corpus (Arabic): {len(ucorpus)} rows, buckets "
              f"{detail['unicode_buckets']}, generated in "
              f"{detail['unicode_generate_seconds']:.1f} s beside the "
              f"builds and the kernel phase "
              f"(waited {detail['unicode_generate_wait_seconds']:.1f} s), "
              f"packed in {detail['unicode_pack_seconds']:.1f} s",
              flush=True)
    with phase("kernel_unicode"):
        unicode_kernel_phase(ucorpus, errs, detail)
    with phase("contract"):
        contract_entry = contract_phase(corpus.device, errs, detail)
    # the card-vs-CPU phases end before any phase that times
    with phase("cpu_parity_wait"):
        got = sides.join("cpu_parity")
        detail["side_seconds"] = {
            "cpu_parity": got.pop("phase_seconds"),
            "boundaries": detail["kernel_boundary_checks"]["seconds"]}
        detail.update(got)
    with phase("serving"):
        paths = _paths(corpus, long_corpus, ucorpus)
        serving = serving_phase(paths, detail)
    corpora = {"ascii": corpus, "long": long_corpus, "arabic": ucorpus}
    with phase("single"):
        single, single_results = single_phase(corpora, hay, serving, detail)
    with phase("indices"):
        indices_phase(corpora, single_results, serving, detail)
        del single_results
    with phase("generic"):
        gpaths = _generic_paths(corpora, hay)
        generic_phase(gpaths, serving, detail)
    with phase("native"):
        native_phase(hay, uhay, detail)
    with phase("parallel"):
        pcalls = parallel_phase(corpus, ucorpus, serving, detail)
    with phase("timing"):
        entries = timing_phase(paths, single, gpaths, pcalls, serving, errs,
                               detail)
        del pcalls
        entries.append(contract_entry)
    with phase("late_build_wait"):
        late_build.join()
        if LATE_BUILD not in late:
            raise RuntimeError(f"{LATE_BUILD} did not build")
        detail["build"][LATE_BUILD] = {
            "seconds": late[LATE_BUILD]["seconds"],
            "ptxas": late[LATE_BUILD]["log"]}
    with phase("probes"):
        entries += probes_phase(corpus.device, errs, detail)
    with phase("profile"):
        profile_phase("fuzzy", corpus, _queries(Q), detail,
                      host_profile=True)
        profile_phase("unicode_fuzzy", ucorpus, _unicode_queries(UQ),
                      detail)
        profile_phase("multi", corpus, _multi_queries(Q), detail)
        single_profile_phase(corpora, detail)
    watchdog.close()
    detail["phase_seconds"] = phases
    detail["total_seconds"] = time.perf_counter() - t_start
    detail["kernels"] = entries
    print("phase seconds: " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()})
        + "; beside them: " + json.dumps(detail["side_seconds"])
        + f"; total {detail['total_seconds']:.3f} s", flush=True)

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
