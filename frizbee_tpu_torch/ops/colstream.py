"""Column-stream fused prefilter + Smith-Waterman (fuzzy mode), the
column-stream literal match (exact, prefix, suffix, substring) and the
whole-row gather, each as a CUDA kernel beside its plain PyTorch version.

Counterpart of ``frizbee_tpu/ops/colstream.py``. Rows come in 1024-row
groups laid out unit-major (``corpus.PackedBucket.device_arrays_colstream``):
group g's unit column j holds rows g*1024 .. g*1024+1023 contiguously, so
one thread per row walks its columns and every DP dependency is a
loop-carried value. The units are int8 bytes (ASCII corpora) or int32
codepoints (unicode corpora, chosen by cpT's dtype); a unicode row carries
its byte offset and byte count through the walk, its windows and end
columns are byte offsets, and its bonus context comes from the int8 ctx
plane (``corpus.ctx_plane``) when one is given, else from the codepoints.

The wrappers dispatch on the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (``csrc/colstream_fuzzy.cu``,
``csrc/colstream_literal.cu``, ``csrc/row_gather.cu``) or raises.
``ops/_build.LAUNCHES`` (one dict for every kernel of the package)
counts kernel launches, so a run can show that its path went through the
kernels.

Semantics contract (pinned against frizbee_tpu in
tests/test_torch_colstream.py and tests/test_torch_literal.py): fuzzy
mode is the positional prefilter with typo budget (greedy embedding at
T=0, minimal-position DP for T=1..3, none when ``no_prefilter`` or the
budget covers the needle), start-1 window trim, affine-gap
Smith-Waterman with the full bonus schedule, exact-match bonus with u16
saturation, and the greedy flag; literal mode is the best contiguous run
of the needle (earliest on ties) scored with the same bonus schedule.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MAX_HAYSTACK_LEN
from ..corpus import (
    CTX_BLEN_SHIFT,
    CTX_DELIM_FIRST,
    CTX_DELIM_LAST,
    CTX_LOWER_LAST,
    CTX_UPPER_FIRST,
    GROUP_ROWS,
)
from . import _build
from ._build import ptr, stream
from .kernels import (
    INT16_SCORE_LIMIT,
    INT64_MAX,
    MAX_KERNEL_NEEDLE,
    check_int16_lanes,
    is_delim,
    is_lower,
    is_upper,
    pack_keys,
    prefilter_mode,
    utf8_context,
)
from .literal import EXACT, LITERAL_MODES, PREFIX, SUBSTRING, SUFFIX

# Per-needle-unit DP state lives in registers, so long needles and large
# typo budgets take the row-major route instead
MAX_COLSTREAM_NEEDLE = 16
MAX_COLSTREAM_TYPOS = 3

FUZZY_MODE = "fuzzy"


def colstream_supported(n: int, max_typos, no_prefilter: bool) -> bool:
    """True when (needle length, typo budget) fits the register budget."""
    if n < 1 or n > MAX_COLSTREAM_NEEDLE:
        return False
    if no_prefilter:
        return True
    return int(max_typos) <= MAX_COLSTREAM_TYPOS


def colstream_literal_supported(n: int) -> bool:
    """Literal (exact/prefix/suffix/substring) support: the bitap
    prefix-alive mask and the per-prefix score sums stay in registers,
    the same budget as the fuzzy DP states."""
    return 1 <= n <= MAX_COLSTREAM_NEEDLE


# the kernels' corpus tile (csrc/colstream_tile.cuh tile_geometry): at most
# TILE_MAX_ROWS rows, TILE_BYTES of staged units (and codepoints' class
# bytes) a block where 32 rows allow it; a block serves at most
# BLOCK_COLUMNS / W queries (1 to MAX_BLOCK_QUERIES), and the queries
# split further until the launch has TARGET_BLOCKS blocks
TILE_MAX_ROWS = 128
TILE_BYTES = 48 * 1024
TARGET_BLOCKS = 1024
BLOCK_COLUMNS = 512
MAX_BLOCK_QUERIES = 32


def tile_geometry(W: int, unit_bytes: int, n_groups: int, Q: int,
                  rows_per_thread: int = 1) -> dict:
    """The launch geometry of the colstream kernels, as
    ``csrc/colstream_tile.cuh`` computes it: ``threads`` a block (128, 64
    or 32, the most whose ``rows_per_thread`` rows of W columns of
    ``unit_bytes`` shared-memory bytes a unit — 1 a byte, 5 a codepoint:
    the unit and its class byte — fit TILE_BYTES), ``rows`` a tile
    (threads x rows_per_thread: 2 in the int16-lane fuzzy kernel, whose
    threads walk two rows), ``qper`` queries a block, ``chunks`` blocks a
    tile, ``tiles`` and ``smem`` (dynamic shared memory bytes a block)."""
    threads = TILE_MAX_ROWS
    while (threads > 32
           and threads * rows_per_thread * W * unit_bytes > TILE_BYTES):
        threads //= 2
    rows = threads * rows_per_thread
    tiles = n_groups * (GROUP_ROWS // rows)
    cap = min(max(BLOCK_COLUMNS // W, 1), MAX_BLOCK_QUERIES)
    split = min(max(-(-TARGET_BLOCKS // tiles), -(-Q // cap)), Q)
    qper = -(-Q // split)
    return dict(threads=threads, rows=rows, qper=qper, chunks=-(-Q // qper),
                tiles=tiles, smem=rows * W * unit_bytes)


def _bonus_bits(first, last):
    """The bonus facts of a unit from its first and last byte, in the ctx
    plane's bit layout (``corpus.ctx_plane``)."""
    bits = torch.where(is_upper(first), CTX_UPPER_FIRST, 0)
    bits = bits | torch.where(is_delim(first), CTX_DELIM_FIRST, 0)
    bits = bits | torch.where(is_lower(last), CTX_LOWER_LAST, 0)
    return bits | torch.where(is_delim(last), CTX_DELIM_LAST, 0)


def _column_reader(cpT, nuT, W, ctxT):
    """column(j) -> (hay, valid, blen, bits) of unit column j for every
    row, each (1, nG*1024) int32: the unit values, the unit-count gate,
    the UTF-8 byte length (0 past the row) and the bonus bits. Bytes are
    their own first and last byte; codepoints read the ctx plane when
    ``ctxT`` is given and derive it otherwise (frizbee_tpu's
    ``_column``)."""
    nG = cpT.shape[0] // W
    hay_all = cpT.reshape(nG, W, GROUP_ROWS)
    ctx_all = None if ctxT is None else ctxT.reshape(nG, W, GROUP_ROWS)
    nu = nuT.reshape(-1)
    unicode = cpT.dtype != torch.int8

    def column(j):
        hay = hay_all[:, j, :].reshape(1, -1).to(torch.int32)
        valid = (nu > j)[None, :]
        if not unicode:
            hay = hay & 0xFF
            first = torch.where(valid, hay, 0)
            return hay, valid, valid.to(torch.int32), _bonus_bits(first,
                                                                  first)
        if ctx_all is not None:
            ctx = ctx_all[:, j, :].reshape(1, -1).to(torch.int32)
            blen = torch.where(valid, (ctx >> CTX_BLEN_SHIFT) & 7, 0)
            return hay, valid, blen, ctx & 0xF
        first, last, blen = utf8_context(hay, valid)
        return hay, valid, blen, _bonus_bits(first, last)

    return column


def _alive_rows(scalars, flags, nG):
    """(Q, nG*1024) bool: group alive = live-count bound and stage-1 flag."""
    g0 = torch.arange(nG, device=scalars.device) * GROUP_ROWS
    alive = g0[None, :] < scalars[:, :1]
    if flags is not None:
        alive = alive & (flags > 0)
    return alive.repeat_interleave(GROUP_ROWS, dim=1)


def colstream_window(
    cpT, nuT, scalars, ctxT=None, *, W: int, n: int, max_typos: int = 0,
    no_prefilter: bool = False,
):
    """Pass 1 of the fuzzy colstream match (the positional prefilter with
    typo budget, after ``frizbee_tpu.ops.colstream._match_block``) for Q
    queries over nG groups: (matched bool, wstart, wend, nb) int32, each
    (Q, nG*1024). ``matched`` is the prefilter's verdict, [wstart, wend)
    the start-1-trimmed byte window that pass 2's DP walks, ``nb`` the
    row's byte count (its unit count on a byte row). Group liveness is not
    applied. Arguments as :func:`match_units_colstream_plain`."""
    T = min(int(max_typos), n)
    unicode = cpT.dtype != torch.int8
    column = _column_reader(cpT, nuT, W, ctxT)
    nu = nuT.reshape(-1)
    shape = (scalars.shape[0], nu.shape[0])
    dev = cpT.device
    z = torch.zeros(shape, dtype=torch.int32, device=dev)
    fz = torch.zeros(shape, dtype=torch.bool, device=dev)
    orig = scalars[:, 2:2 + n]
    flip = scalars[:, 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n]

    def orig_k(k):
        return orig[:, k:k + 1]

    def flip_k(k):
        return flip[:, k:k + 1]

    jmaxu = min(int(nu.max()), W) if nu.numel() else 0

    auto = (not no_prefilter) and n <= T
    run_pf = (not no_prefilter) and not auto
    ffound, efound = fz.clone(), fz.clone()
    sbyte, ebyte = z.clone(), z.clone()
    boff = z  # byte offset of column j (== j on a byte row)

    def track(hit_start, hit_end, blen):
        nonlocal ffound, efound, sbyte, ebyte
        sbyte = torch.where(~ffound & hit_start, boff, sbyte)
        ffound = ffound | hit_start
        ebyte = torch.where(hit_end, boff + blen, ebyte)
        efound = efound | hit_end

    if run_pf and T == 0:
        # greedy leftmost embedding: np_ = needle units consumed
        np_ = z.clone()
        for j in range(jmaxu):
            hay, valid, blen, _bits = column(j)
            occ_np = fz
            hit0 = occ_last = None
            for k in range(n):
                occ_k = valid & ((hay == orig_k(k)) | (hay == flip_k(k)))
                occ_np = occ_np | ((np_ == k) & occ_k)
                if k == 0:
                    hit0 = occ_k
                if k == n - 1:
                    occ_last = occ_k
            np2 = np_ + occ_np.to(torch.int32)
            track(hit0, occ_last & (np2 >= n), blen)
            np_ = np2
            boff = boff + blen
        matched = np_ >= n
    elif run_pf:
        # minimal-position DP over T+1 deletion budgets
        g = [torch.full(shape, t, dtype=torch.int32, device=dev)
             for t in range(T + 1)]
        for j in range(jmaxu):
            hay, valid, blen, _bits = column(j)
            hits = [fz] * (T + 1)
            hit_low, hit_tail = fz, fz
            for k in range(n):
                occ_k = valid & ((hay == orig_k(k)) | (hay == flip_k(k)))
                for t in range(T + 1):
                    hits[t] = hits[t] | ((g[t] == k) & occ_k)
                if k <= T:
                    hit_low = hit_low | occ_k
                if k >= n - 1 - T:
                    hit_tail = hit_tail | occ_k
            g = [g[t] + hits[t].to(torch.int32) for t in range(T + 1)]
            for t in range(1, T + 1):
                g[t] = torch.maximum(g[t], g[t - 1] + 1)
            track(hit_low, hit_tail, blen)
            boff = boff + blen
        matched = g[T] >= n
    else:
        matched = torch.ones(shape, dtype=torch.bool, device=dev)
        if unicode:
            for j in range(jmaxu):
                boff = boff + column(j)[2]
    # the row's UTF-8 byte count (its unit count on a byte row)
    nb = boff if unicode else torch.clamp(nu, max=W)[None, :].expand(shape)
    if run_pf:
        wstart_raw = torch.where(matched & ffound, sbyte, 0)
        wend = torch.where(matched & efound, ebyte, nb)
    else:
        wstart_raw, wend = z, nb
    return matched, torch.clamp(wstart_raw - 1, min=0), wend, nb


def colstream_window_units(cpT, nuT, wstart, wend, ctxT=None, *, W: int):
    """(Q, nG*1024) int32: the units of each row inside its byte window
    [wstart, wend) (:func:`colstream_window`), the columns that pass 2's
    DP walks."""
    column = _column_reader(cpT, nuT, W, ctxT)
    nu = nuT.reshape(-1)
    jmaxu = min(int(nu.max()), W) if nu.numel() else 0
    count = torch.zeros_like(wstart)
    boff = torch.zeros_like(wstart)
    for j in range(jmaxu):
        _hay, valid, blen, _bits = column(j)
        count = count + (valid & (boff >= wstart)
                         & (boff + blen <= wend)).to(torch.int32)
        boff = boff + blen
    return count


def match_units_colstream_plain(
    cpT, nuT, scalars, flags=None, idxT=None, ctxT=None, *, W: int, n: int,
    max_typos: int = 0, scoring: Tuple[int, ...], no_prefilter: bool = False,
    idx_bits: int = 0, int16_lanes: bool = False,
):
    """Plain PyTorch version of the colstream kernel: vectorized over
    (query, row), Python loops over unit columns and needle units, line
    for line after ``frizbee_tpu.ops.colstream._match_block``: pass 1 is
    :func:`colstream_window`, pass 2 the windowed Smith-Waterman.

    cpT (nG*W, 8, 128) int8 bytes or int32 codepoints, nuT (nG*8, 128)
    int32, scalars (Q, 130) int32 (``kernels.pack_needle_scalars``;
    [q, 0] is the live row count), flags (Q, nG) int32 or None, ctxT
    (nG*W, 8, 128) int8 ctx plane or None (codepoint blocks only).
    Returns int64 keys (Q, nG*1024) when ``idxT`` (nG*1024,) is given,
    else the five int32 columns (matched, score, exact, end_col, greedy),
    each (Q, nG*1024). Windows and end_col are byte offsets.

    ``int16_lanes`` (byte rows, ``kernels.score_fits_int16``) runs pass 2
    — scores, the gap carries, offsets, flags, best and end — in
    ``torch.int16``, as the reference's ``_match_block(int16_lanes=True)``
    does."""
    (match_score, mismatch, gap_open, gap_ext, prefix_b, cap_b, case_b,
     exact_b, delim_b) = (int(s) for s in scoring)
    gop_extra = max(gap_open - gap_ext, 0)
    nG = cpT.shape[0] // W
    unicode = cpT.dtype != torch.int8
    if int16_lanes:
        check_int16_lanes(unicode, scoring, n, W)
        mismatch = min(mismatch, INT16_SCORE_LIMIT)
    dt = torch.int16 if int16_lanes else torch.int32
    column = _column_reader(cpT, nuT, W, ctxT)
    nu = nuT.reshape(-1)
    dev = cpT.device
    orig = scalars[:, 2:2 + n]
    flip = scalars[:, 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n]

    def orig_k(k):
        return orig[:, k:k + 1]

    def flip_k(k):
        return flip[:, k:k + 1]

    jmaxu = min(int(nu.max()), W) if nu.numel() else 0
    matched, wstart, wend, nb = colstream_window(
        cpT, nuT, scalars, ctxT, W=W, n=n, max_typos=max_typos,
        no_prefilter=no_prefilter)
    z = torch.zeros(matched.shape, dtype=dt, device=dev)
    fz = torch.zeros(matched.shape, dtype=torch.bool, device=dev)

    def const(mask, v):
        # v where mask holds, else 0, in the DP's lane type
        return torch.where(mask, torch.tensor(v, dtype=dt, device=dev),
                           torch.tensor(0, dtype=dt, device=dev))

    # ---- pass 2: windowed affine-gap SW (bonus schedule) ----------------
    include_exact = (wstart == 0) & (wend == nb)
    include_prefix = wstart == 0
    # a byte row's window ends at a unit column, so the walk stops at the
    # furthest matched window end; a codepoint row's at a byte offset
    sw_bound = jmaxu if unicode else min(
        int(torch.where(matched, wend, 0).max()), jmaxu)
    wstart_d, wend_d = wstart.to(dt), wend.to(dt)
    orig_d, flip_d = orig.to(dt), flip.to(dt)
    h = [z] * n
    mm_bits, pctx, seen_first, best, end_b, boff = z, z, z, z, z, z
    for j in range(sw_bound):
        hay, valid, blen, bits = (t.to(dt) for t in column(j))
        valid = valid > 0
        active = valid & (boff >= wstart_d) & (boff + blen <= wend_d)
        is_first = active & (seen_first == 0)
        seen_first = seen_first | active.to(dt)
        cap_mask = ((bits & CTX_UPPER_FIRST) > 0) & ((pctx & 1) > 0) \
            & ~is_first
        delim_mask = ((pctx & 2) > 0) & ((bits & CTX_DELIM_FIRST) == 0) \
            & ~is_first
        bonus = (const(cap_mask, cap_b) + const(delim_mask, delim_b)
                 + const(is_first & include_prefix, prefix_b))
        # [lower(last byte), delim(last byte)] for the next column
        pctx = torch.where(valid, (bits >> 2) & 3, 0)
        diag_in, up_src, mm_prev = z, z, fz
        h_new, mm_new = [], z
        for k in range(n):
            ok, fk = orig_d[:, k:k + 1], flip_d[:, k:k + 1]
            occ = active & ((hay == ok) | (hay == fk))
            hit = match_score + bonus + const(active & (hay == ok), case_b)
            left = h[k] - gap_ext
            if gop_extra:
                left = left - const(((mm_bits >> k) & 1) > 0, gop_extra)
            if k == 0:
                cur = torch.maximum(torch.where(occ, hit, 0), left)
            else:
                diag = torch.where(
                    occ, diag_in + hit, torch.clamp(diag_in - mismatch, min=0)
                )
                up = up_src - gap_ext
                if gop_extra:
                    up = up - const(mm_prev, gop_extra)
                up = torch.clamp(up, min=0)
                cur = torch.maximum(torch.maximum(diag, up), left)
            diag_in, up_src, mm_prev = h[k], cur, occ
            h_new.append(cur)
            mm_new = mm_new | (occ.to(dt) << k)
            if k == n - 1:
                masked = torch.where(active, cur, 0)
                end_b = torch.where(masked > best, boff, end_b)
                best = torch.maximum(best, masked)
        h, mm_bits = h_new, mm_new
        boff = boff + blen

    # exact: haystack unit j vs needle unit j, case-sensitive
    neq = fz
    for j in range(min(n, W)):
        neq = neq | (column(j)[0] != orig_k(j))
    score = torch.clamp(best.to(torch.int32), min=0)
    end_col = torch.where(score > 0, end_b.to(torch.int32), wstart)
    exact = include_exact & (nu == n)[None, :] & ~neq
    score = torch.where(exact, torch.clamp(score + exact_b, max=0xFFFF), score)
    score = torch.where(matched, score, 0)
    exact = exact & matched
    end_col = torch.where(matched, end_col, 0)
    greedy = matched & ((wend - wstart) > MAX_HAYSTACK_LEN)
    cols = (matched.to(torch.int32), score.to(torch.int32),
            exact.to(torch.int32), end_col.to(torch.int32),
            greedy.to(torch.int32))

    alive = _alive_rows(scalars, flags, nG)
    if idxT is not None:
        keys = pack_keys(*cols, idxT.reshape(1, -1), idx_bits)
        return torch.where(alive, keys, torch.full_like(keys, INT64_MAX))
    return tuple(torch.where(alive, c, 0) for c in cols)


def match_units_colstream_literal_plain(
    cpT, nuT, scalars, flags=None, idxT=None, ctxT=None, *, W: int, n: int,
    mode: str, needle_byte_len: int, scoring: Tuple[int, ...],
    idx_bits: int = 0,
):
    """Plain PyTorch version of the literal colstream kernel, line for
    line after ``frizbee_tpu.ops.colstream._literal_block``: one walk over
    the unit columns carrying a bitap prefix-alive mask ``D`` (bit k = a
    run of needle units 0..k ends at this column), per-prefix score sums
    ``S[k]`` and the runs' start bytes ``SB[k]``; a completed run scores
    n*match + its bonus/case sum (+ the exact bonus when it covers the
    whole row, clamped to u16), and a strict ``>`` keeps the earliest best
    run. EXACT and PREFIX runs can only complete at column n-1, so those
    modes walk n columns.

    Arguments and results as :func:`match_units_colstream_plain` (greedy
    is always 0, end_col = the run's start byte + ``needle_byte_len`` -
    1; exact needs the run to cover every byte of the row)."""
    (match_score, _mm, _gop, _gex, prefix_b, cap_b, case_b, exact_b,
     delim_b) = (int(s) for s in scoring)
    nG = cpT.shape[0] // W
    Q = scalars.shape[0]
    unicode = cpT.dtype != torch.int8
    column = _column_reader(cpT, nuT, W, ctxT)
    nu = nuT.reshape(-1)
    shape = (Q, nu.shape[0])
    dev = cpT.device
    z = torch.zeros(shape, dtype=torch.int32, device=dev)
    orig = scalars[:, 2:2 + n]
    flip = scalars[:, 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n]
    jmaxu = min(int(nu.max()), W) if nu.numel() else 0
    bound = min(jmaxu, n) if mode in (EXACT, PREFIX) else jmaxu
    nu_row = nu[None, :]

    D = z
    S = [z] * n
    SB = [z] * n
    best = torch.full(shape, -1, dtype=torch.int32, device=dev)
    b_sb, b_p0, pctx, boff = z, z, z, z
    for j in range(bound):
        hay, valid, blen, bits = column(j)
        # column 0 takes the prefix bonus; later columns the capitalization
        # / delimiter context of the previous unit, carried in pctx
        if j == 0:
            bonus = torch.full(shape, prefix_b, dtype=torch.int32, device=dev)
        else:
            bonus = (
                torch.where(((bits & CTX_UPPER_FIRST) > 0) & ((pctx & 1) > 0),
                            cap_b, 0)
                + torch.where(((pctx & 2) > 0)
                              & ((bits & CTX_DELIM_FIRST) == 0), delim_b, 0)
            )
        pctx = torch.where(valid, (bits >> 2) & 3, 0)
        D_new = z
        S_new, SB_new = [], []
        for k in range(n):
            eq_o = valid & (hay == orig[:, k:k + 1])
            occ = eq_o | (valid & (hay == flip[:, k:k + 1]))
            s_k = bonus + torch.where(eq_o, case_b, 0)
            if k == 0:
                alive = occ
                sb_k = boff
            else:
                alive = occ & (((D >> (k - 1)) & 1) > 0)
                s_k = S[k - 1] + s_k
                sb_k = SB[k - 1]
            D_new = D_new | (alive.to(torch.int32) << k)
            S_new.append(torch.where(alive, s_k, 0))
            SB_new.append(torch.where(alive, sb_k, 0))
        done, s_done = alive, S_new[-1]
        # completion: a run of n units ends at column j, so it starts at
        # unit j-n+1 (at unit 0 iff j == n-1)
        at_p0 = j == n - 1
        cand = n * match_score + s_done
        if at_p0:
            cand = cand + torch.where(nu_row == n, exact_b, 0)
        cand = torch.clamp(cand, max=0xFFFF)
        if mode == EXACT:
            sel = done & at_p0 & (nu_row == n)
        elif mode == PREFIX:
            sel = done & at_p0
        elif mode == SUFFIX:
            sel = done & (nu_row - 1 == j)
        elif mode == SUBSTRING:
            sel = done
        else:
            raise ValueError(f"unknown literal mode {mode!r}")
        upd = sel & (cand > best)
        best = torch.where(upd, cand, best)
        b_sb = torch.where(upd, SB_new[-1], b_sb)
        b_p0 = torch.where(upd, int(at_p0), b_p0)
        D, S, SB = D_new, S_new, SB_new
        boff = boff + blen

    # the row's byte count: a byte row's unit count; a codepoint row's
    # byte sum, walked on past the short modes' bound
    if unicode:
        nb = boff
        for j in range(bound, jmaxu):
            nb = nb + column(j)[2]
    else:
        nb = torch.clamp(nu_row, max=W)
    matched = best >= 0
    score = torch.where(matched, best, 0)
    end_col = torch.where(
        matched, torch.clamp(b_sb + needle_byte_len - 1, max=0xFFFF), 0
    )
    exact = matched & (b_p0 > 0) & (nb == needle_byte_len)
    cols = (matched.to(torch.int32), score.to(torch.int32),
            exact.to(torch.int32), end_col.to(torch.int32), z)
    alive = _alive_rows(scalars, flags, nG)
    if idxT is not None:
        keys = pack_keys(*cols, idxT.reshape(1, -1), idx_bits)
        return torch.where(alive, keys, torch.full_like(keys, INT64_MAX))
    return tuple(torch.where(alive, c, 0) for c in cols)


def match_units_colstream(
    cpT, nuT, scalars, flags=None, idxT=None, ctxT=None, *, W: int, n: int,
    max_typos: int = 0, scoring: Tuple[int, ...], no_prefilter: bool = False,
    idx_bits: int = 0, mode: str = FUZZY_MODE, needle_byte_len: int = 0,
    int16_lanes: bool = False,
):
    """Fused match over nG groups of 1024 rows for Q queries in one
    launch (grid = groups x queries): fuzzy mode (default) or a literal
    ``mode`` (exact, prefix, suffix, substring; ``needle_byte_len`` sets
    end_col, ``max_typos`` is ignored). cpT's dtype picks the units: int8
    bytes, or int32 codepoints with the optional int8 ctx plane ``ctxT``.
    Arguments and results as :func:`match_units_colstream_plain`.

    ``flags`` (Q, nG) carries the per-group stage-1 alive bits: a dead
    group holds no stage-1 survivor, so the kernel writes zeros (or
    INT64_MAX keys) without running the DP. Key-emit mode (``idxT``
    given) writes the serving sort key directly: ascending order is
    (matched first, score desc, index asc).

    ``int16_lanes`` (fuzzy mode on byte rows where
    ``kernels.score_fits_int16`` holds, else ValueError) selects the
    int16-lane instantiation, two rows a thread: the same results, counted
    in ``_build.LAUNCHES["colstream_fuzzy_i16"]``."""
    literal = mode != FUZZY_MODE
    if literal and mode not in LITERAL_MODES:
        raise ValueError(f"unknown match mode {mode!r}")
    if int16_lanes and literal:
        raise ValueError("int16 lanes serve fuzzy mode only")
    if cpT.device.type == "cpu":
        if literal:
            return match_units_colstream_literal_plain(
                cpT, nuT, scalars, flags, idxT, ctxT, W=W, n=n, mode=mode,
                needle_byte_len=needle_byte_len, scoring=scoring,
                idx_bits=idx_bits,
            )
        return match_units_colstream_plain(
            cpT, nuT, scalars, flags, idxT, ctxT, W=W, n=n,
            max_typos=max_typos, scoring=scoring, no_prefilter=no_prefilter,
            idx_bits=idx_bits, int16_lanes=int16_lanes,
        )
    if cpT.device.type != "cuda":
        raise ValueError(f"unsupported device {cpT.device}")
    T = min(int(max_typos), n)
    if literal:
        if not colstream_literal_supported(n):
            raise ValueError(f"literal needle length {n} out of range")
    elif not colstream_supported(n, T, no_prefilter):
        raise ValueError(f"needle length {n} / typo budget {T} out of range")
    unicode = cpT.dtype != torch.int8
    if not unicode and ctxT is not None:
        raise ValueError("a ctx plane goes with codepoint blocks only")
    if int16_lanes:
        check_int16_lanes(unicode, scoring, n, W)
    nG = cpT.shape[0] // W
    Q = scalars.shape[0]
    total = nG * GROUP_ROWS
    if any(t is not None and t.data_ptr() % 16 for t in (cpT, ctxT)):
        raise ValueError("cpT and ctxT must be 16-byte aligned: the kernel "
                         "stages them with 16-byte copies")
    _build.check_operands(cpT.device, (
        ("cpT", cpT, torch.int32 if unicode else torch.int8,
         (nG * W, 8, 128)),
        ("ctxT", ctxT, torch.int8, (nG * W, 8, 128)),
        ("nuT", nuT, torch.int32, (nG * 8, 128)),
        ("scalars", scalars, torch.int32, (Q, 2 + 2 * MAX_KERNEL_NEEDLE)),
        ("flags", flags, torch.int32, (Q, nG)),
        ("idxT", idxT, torch.int32, (total,)),
    ))
    keys = cols = None
    if idxT is not None:
        keys = torch.empty((Q, total), dtype=torch.int64, device=cpT.device)
    else:
        cols = torch.empty((5, Q, total), dtype=torch.int32,
                           device=cpT.device)
    _sc, sc_ptr = _build.scoring_arg(scoring)
    call_args = (cpT, nuT, scalars, flags, idxT, ctxT)
    if literal:
        _build.launch(
            "colstream_literal", cpT.device,
            ptr(cpT), ptr(ctxT), ptr(nuT), ptr(scalars), ptr(flags),
            ptr(idxT), Q, nG, W, n, int(unicode), LITERAL_MODES.index(mode),
            needle_byte_len, sc_ptr, idx_bits, ptr(keys), ptr(cols),
            stream(cpT),
            call=(call_args, dict(W=W, n=n, mode=mode,
                                  needle_byte_len=needle_byte_len,
                                  scoring=scoring, idx_bits=idx_bits)),
        )
    else:
        _build.launch(
            "colstream_fuzzy", cpT.device,
            ptr(cpT), ptr(ctxT), ptr(nuT), ptr(scalars), ptr(flags),
            ptr(idxT), Q, nG, W, n, int(unicode), int(int16_lanes), T,
            prefilter_mode(n, T, no_prefilter), sc_ptr, idx_bits,
            ptr(keys), ptr(cols), stream(cpT),
            call=(call_args, dict(W=W, n=n, max_typos=max_typos,
                                  scoring=scoring, no_prefilter=no_prefilter,
                                  idx_bits=idx_bits,
                                  int16_lanes=int16_lanes)),
            count="colstream_fuzzy_i16" if int16_lanes else None,
        )
    return keys if keys is not None else tuple(cols)


def row_gather_plain(data: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`: advanced indexing."""
    return data[rows.to(torch.int64)]


def row_gather(data: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[i, :] = data[rows[i], :] for a contiguous (R, C) matrix of
    4-byte words, C a multiple of 128, rows (M,) int32 in [0, R).

    Serves the capped finalize (1024-row groups of int64 keys viewed as
    2048 int32 words) and the broad tournament (128-key blocks viewed as
    256 words). The kernel does not check the row ids: an id outside
    [0, R) is the caller's error."""
    if data.device.type == "cpu":
        return row_gather_plain(data, rows)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if (data.dim() != 2 or data.element_size() != 4
            or data.shape[1] % 128 or not data.is_contiguous()
            or data.data_ptr() % 16):
        raise ValueError(
            "row_gather wants a contiguous, 16-byte aligned (R, C) matrix "
            f"of 4-byte words with C % 128 == 0; got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    if (rows.device != data.device or rows.dtype != torch.int32
            or rows.dim() != 1 or not rows.is_contiguous()):
        raise ValueError("row_gather wants contiguous int32 rows (M,) "
                         "on the data's device")
    C = data.shape[1]
    M = rows.shape[0]
    out = torch.empty((M, C), dtype=data.dtype, device=data.device)
    _build.launch("row_gather", data.device, ptr(data), ptr(rows), ptr(out),
                  C, M, stream(data), call=((data, rows), {}))
    return out
