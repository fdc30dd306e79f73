"""The row-major fused prefilter + Smith-Waterman kernel (``match_units``,
CUDA kernel ``csrc/match_units.cu`` beside its plain PyTorch version),
the needle scalar layout and the serving sort key shared by every match
kernel. Rows are int8 bytes (ASCII corpora) or int32 codepoints (unicode
corpora), whose UTF-8 context (first and last byte, byte offset and
length) the kernel derives from the codepoints.

Counterpart of ``frizbee_tpu/ops/kernels.py``. The row-major route serves
what the column-stream kernels cannot hold in registers: fuzzy needles of
17-64 units and typo budgets of 4-8. Rows stay in the bucket's (B, W)
row-major layout, so the serving flow can hand the kernel a per-query
survivor order and a live count instead of gathering rows: rows past the
count are never read. The reference's narrow-bucket segment packing exists
only for the TPU's 128-lane vectors and is not ported; the results are the
same per row (pinned in tests/test_torch_rowmajor.py). Its int16 lanes are
ported as the ``int16_lanes`` instantiation: on the card, two rows a thread
in the s16x2 halves of 32-bit registers (Hopper's DPX add-max); in the
plain version, DP state in ``torch.int16``. ASCII rows only, and only where
:func:`score_fits_int16` holds (pinned in tests/test_torch_int16_lanes.py).
:func:`fuzzy_match_units` runs the kernel in columns mode for the generic
body (index sorts, multi-pattern atoms beyond the colstream budgets): a
stage-1 reject, the kernel over each query's survivors, the columns back
in bucket row order.
"""

from __future__ import annotations

import torch

from ..config import MAX_HAYSTACK_LEN
from . import _build

# Longest needle the scalar layout holds (the orig/flip pad size)
MAX_KERNEL_NEEDLE = 64
# Largest typo budget the row-major kernel's DP states cover
MAX_KERNEL_TYPOS = 8

DEFAULT_SCORING = (12, 6, 5, 1, 12, 4, 4, 8, 4)

INT64_MAX = (1 << 63) - 1

# int16-lane DP: every cell stays below this (score_fits_int16), and a
# mismatch or gap cost beyond it takes a cell to the relu floor all the
# same, so the int16 DP clamps those costs to it
INT16_SCORE_LIMIT = 30000

# The card serves int16 lanes only where they are proven faster there: the
# counterpart of the reference's INT16_MOSAIC_OK (which stays False on the
# TPU). The first int16 kernel (two survivor-order neighbours a thread,
# walking the union of their windows) was faster in 0 of 10 alternating
# rounds on the same launches; its redesign (256-row blocks, a queue
# ordered by window length, each half on its own window) won 10 of 10 on
# the typo batch (2.8265 against 3.4567 ms) and on the long-needle batch
# (0.6440 against 0.7133 ms), medians on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md §6, the int16 rows' A/B), so the card serves int16 lanes
# where the rows fit, as the CPU does.
INT16_CUDA_OK = True

# Prefilter modes of the CUDA kernels
PF_NONE, PF_GREEDY, PF_DP = 0, 1, 2


def score_fits_int16(scoring, n: int, width: int) -> bool:
    """True when every DP intermediate provably fits int16 lanes: the
    largest cell, n * (match + matching_case + max(cap, delim)) + prefix +
    exact (context bonuses exclude each other per unit), plus the gap
    scan's W * (gap_extend + gap_open') stays below INT16_SCORE_LIMIT.
    The port's copy of ``frizbee_tpu.ops.kernels.score_fits_int16``."""
    (match_score, _mismatch, gap_open, gap_ext, prefix_b, cap_b, case_b,
     exact_b, delim_b) = scoring
    per_char = match_score + case_b + max(cap_b, delim_b)
    bound = n * per_char + prefix_b + exact_b
    qmax = width * (gap_ext + max(gap_open - gap_ext, 0))
    return bound + qmax < INT16_SCORE_LIMIT


def int16_lanes_fit(unicode: bool, scoring, n: int, width: int) -> bool:
    """Whether the int16-lane instantiations serve these rows: byte rows
    (codepoints exceed int16), a scoring of non-negative costs and bonuses
    (a row's cells before its window stay 0 only then) that
    :func:`score_fits_int16` admits at this needle length and width. The
    serving dispatch's predicate, after the reference's
    ``(not unicode) and score_fits_int16(scoring, nlen, width)``."""
    return (not unicode and all(int(s) >= 0 for s in scoring)
            and score_fits_int16(scoring, n, width))


def int16_lanes_dispatch(device, unicode: bool, scoring, n: int,
                         width: int) -> bool:
    """Whether the serving flow launches the int16-lane instantiation:
    :func:`int16_lanes_fit`, and the device is the CPU or
    ``INT16_CUDA_OK`` holds. The reference's dispatch is ``(not unicode)
    and score_fits_int16(...) and (interpret or INT16_MOSAIC_OK)``; the
    CPU's plain versions stand where its interpret mode does."""
    return (int16_lanes_fit(unicode, scoring, n, width)
            and (torch.device(device).type == "cpu" or INT16_CUDA_OK))


def check_int16_lanes(unicode: bool, scoring, n: int, width: int) -> None:
    """Raise ValueError unless :func:`int16_lanes_fit` holds."""
    if unicode:
        raise ValueError("int16 lanes hold byte rows only, not codepoints")
    if not int16_lanes_fit(unicode, scoring, n, width):
        raise ValueError(
            f"scoring {tuple(scoring)} does not fit int16 lanes at needle "
            f"length {n} and width {width}")


def prefilter_mode(n: int, T: int, no_prefilter: bool) -> int:
    """The positional prefilter a (needle length, clamped budget) runs:
    none (no prefilter, or the budget covers the needle), the greedy
    embedding at T=0, else the minimal-position DP."""
    if no_prefilter or n <= T:
        return PF_NONE
    return PF_GREEDY if T == 0 else PF_DP


def pack_needle_scalars(needle_packed: torch.Tensor, count) -> torch.Tensor:
    """[count, n, orig x MAXN, flip x MAXN] int32 per query.

    ``needle_packed`` is (2n,) or (Q, 2n): orig then flip units. The flip
    units start at offset ``2 + MAX_KERNEL_NEEDLE``, not ``2 + n``."""
    n = needle_packed.shape[-1] // 2
    assert n <= MAX_KERNEL_NEEDLE
    lead = needle_packed.shape[:-1]
    out = torch.zeros(
        lead + (2 + 2 * MAX_KERNEL_NEEDLE,), dtype=torch.int32,
        device=needle_packed.device,
    )
    out[..., 0] = int(count)
    out[..., 1] = n
    out[..., 2:2 + n] = needle_packed[..., :n].to(torch.int32)
    out[..., 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n] = (
        needle_packed[..., n:].to(torch.int32)
    )
    return out


def pack_keys(matched, score, exact, end_col, greedy, idx, idx_bits):
    """63-bit sort keys [0xFFFF-score | idx | exact, greedy, end_col];
    unmatched or padding rows carry INT64_MAX."""
    ok = (matched > 0) & (idx >= 0)
    meta16 = (
        (exact.to(torch.int64) << 15) | (greedy.to(torch.int64) << 14)
        | torch.clamp(end_col, max=0x3FFF).to(torch.int64)
    )
    key = (
        ((0xFFFF - score).to(torch.int64) << (16 + idx_bits))
        | (idx.to(torch.int64) << 16) | meta16
    )
    return torch.where(ok, key, torch.full_like(key, INT64_MAX))


def is_upper(b):
    return (b >= 0x41) & (b <= 0x5A)


def is_lower(b):
    return (b >= 0x61) & (b <= 0x7A)


def is_delim(b):
    letter = is_upper(b) | is_lower(b)
    digit = (b >= 0x30) & (b <= 0x39)
    return (b >= 0) & (b <= 127) & ~letter & ~digit


def _shift_right(x, fill):
    """Lanes one to the right (toward higher index), lane 0 = ``fill``."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], dim=1)


def utf8_context(hay, valid):
    """(first byte, last byte, byte length) of int32 codepoints, the first
    byte and length 0 where ``valid`` is false."""
    blen = (1 + (hay >= 0x80).to(torch.int32) + (hay >= 0x800).to(torch.int32)
            + (hay >= 0x10000).to(torch.int32))
    blen = torch.where(valid, blen, 0)
    first = torch.where(
        hay < 0x80, hay,
        torch.where(hay < 0x800, 0xC0 | (hay >> 6),
                    torch.where(hay < 0x10000, 0xE0 | (hay >> 12),
                                0xF0 | (hay >> 18))),
    )
    first = torch.where(valid, first, 0)
    last = torch.where(hay < 0x80, hay, 0x80 | (hay & 0x3F))
    return first, last, blen


def _unit_context(hay, valid, col):
    """(first byte, previous unit's last byte (-1 at the row start and
    past it), byte offset, byte length, byte count) of (R, W) units, as
    frizbee_tpu's ``_unit_context`` derives them: bytes are their own
    first and last byte; codepoints take their UTF-8 lead and last byte
    and length, and the offsets are the exclusive byte-length sums."""
    if hay.dtype == torch.int8:
        first = last = hay.to(torch.int32) & 0xFF
        blen = valid.to(torch.int32)
        boff = torch.where(valid, col, 0)
    else:
        first, last, blen = utf8_context(hay, valid)
        boff = _shift_right(torch.cumsum(blen, dim=1, dtype=torch.int32), 0)
        boff = torch.where(valid, boff, 0)
    prev = torch.where(valid, _shift_right(last, -1), -1)
    return first, prev, boff, blen, blen.sum(dim=1, dtype=torch.int32)


def _lane_min(x):
    return x.amin(dim=1)


def _lane_max(x):
    return x.amax(dim=1)


def _lane_gather(x, idx):
    """x[r, idx[r]] of (R, W) x, one column per row."""
    return x.gather(1, idx[:, None].to(torch.int64))[:, 0]


def _unit_grid(hay_in, nu):
    """(int32 units, valid mask, column index (1, W), unit context) of (R,
    W) rows with unit counts nu: :func:`_unit_context`'s first byte,
    previous last byte, byte offset, byte length and byte count."""
    R, W = hay_in.shape
    i32 = torch.int32
    hay = hay_in.to(i32)
    if hay_in.dtype == torch.int8:
        hay = hay & 0xFF
    col = torch.arange(W, dtype=i32, device=hay_in.device)[None, :]
    valid = col < torch.clamp(nu, max=W + 1)[:, None]
    return hay, valid, col, _unit_context(hay_in, valid, col)


def _prefilter(hay, valid, col, boff, blen, n_bytes, orig, flip, *, n, T,
               no_prefilter):
    """Pass 1 of the row-major match over :func:`_unit_grid`'s arrays:
    the positional prefilter — f[t] = position after needle units 0..k
    with <= t of them deleted (BIG = no embedding) — and the byte window
    it leaves. Returns (matched bool, wstart_raw, wend, n_bytes), each
    (R,); rejected rows keep the whole row [0, n_bytes)."""
    R, W = hay.shape
    S = W
    BIG = S + 1
    i32 = torch.int32
    dev = hay.device
    zero = torch.zeros(R, dtype=i32, device=dev)

    if no_prefilter or n <= T:
        # no prefilter, or a needle no longer than the typo budget: every
        # row matches
        return (torch.ones(R, dtype=torch.bool, device=dev), zero, n_bytes,
                n_bytes)
    f = [zero] * (T + 1)
    fos = torch.full((R,), BIG, dtype=i32, device=dev)
    start0 = zero
    tail = torch.zeros((R, W), dtype=torch.bool, device=dev)
    for k in range(n):
        occ = valid & ((hay == orig[k]) | (hay == flip[k]))
        if k <= T:
            fos = torch.minimum(fos, _lane_min(torch.where(occ, col, BIG)))
        nf = []
        for t in range(T + 1):
            nxt_occ = _lane_min(
                torch.where(occ & (col >= f[t][:, None]), col, BIG)
            )
            nxt = torch.where(
                f[t] <= S, torch.clamp(nxt_occ + 1, max=BIG), BIG
            )
            if t > 0:
                nxt = torch.minimum(nxt, f[t - 1])
            nf.append(nxt)
        if k == 0:
            start0 = torch.clamp(nf[0] - 1, max=S)
        if k >= n - 1 - T:
            tail = tail | occ
        f = nf
    matched = f[T] <= S
    if T == 0:
        last_pos = f[0] - 1
        e = _lane_max(torch.where(tail & (col >= last_pos[:, None]), col, -1))
        wstart_raw = _lane_gather(boff, torch.clamp(start0, 0, S - 1))
    else:
        e = _lane_max(torch.where(tail, col, -1))
        wstart_raw = torch.where(
            fos <= S, _lane_gather(boff, torch.clamp(fos, 0, S - 1)), 0
        )
    e_c = torch.clamp(e, 0, S - 1)
    wend = torch.where(
        e >= 0, _lane_gather(boff, e_c) + _lane_gather(blen, e_c), n_bytes)
    wstart_raw = torch.where(matched, wstart_raw, 0)
    wend = torch.where(matched, wend, n_bytes)
    return matched, wstart_raw, wend, n_bytes


def _window_active(valid, boff, blen, wstart, wend):
    """The units of each row inside its trimmed byte window [wstart,
    wend): the columns the SW DP walks."""
    return (valid & (boff >= wstart[:, None])
            & (boff + blen <= wend[:, None]))


def prefilter_window(hay_in, nu, orig, flip, *, n, T, no_prefilter):
    """Pass 1 of the row-major match of R rows (R, W) — int8 bytes or
    int32 codepoints — against one needle (``orig``/``flip`` lists of n
    ints) at typo budget T (clamped to n): (matched bool, wstart_raw,
    wend, n_bytes) int32, each (R,), as :func:`_match_rows_plain` and the
    CUDA kernel compute them. The window is in bytes; pass 2 trims its
    start by one."""
    hay, valid, col, (_fb, _prev, boff, blen, n_bytes) = _unit_grid(
        hay_in, nu)
    return _prefilter(hay, valid, col, boff, blen, n_bytes, orig, flip,
                      n=n, T=T, no_prefilter=no_prefilter)


def window_units(hay_in, nu, wstart_raw, wend):
    """(R,) int64 count of the units pass 2 walks in each row: those of
    the byte window [max(wstart_raw - 1, 0), wend)."""
    _hay, valid, _col, (_fb, _prev, boff, blen, _nb) = _unit_grid(
        hay_in, nu)
    wstart = torch.clamp(wstart_raw - 1, min=0)
    return _window_active(valid, boff, blen, wstart, wend).sum(dim=1)


def _match_rows_plain(hay_in, nu, orig, flip, *, n, T, scoring, no_prefilter,
                      int16_lanes=False):
    """Row-major fused match of R rows (R, W) — int8 bytes or int32
    codepoints — with unit counts nu (R,) against one needle
    (``orig``/``flip`` lists of n ints), line for line after
    ``frizbee_tpu.ops.kernels._match_tile`` with one row per vector
    (lanes = unit columns): the minimal-position prefilter over needle
    units (:func:`_prefilter`), lane min/max reductions for the window,
    and the left-to-right gap recurrence as an exact max-plus prefix scan
    (``cummax(c + q) - q``). Windows and end_col are byte offsets.
    Returns (matched, score, exact, end_col, greedy) int32, each (R,). As
    in the reference, rows the prefilter rejects still carry the full-row
    DP's score, exact and end_col.

    ``int16_lanes`` (byte rows, :func:`score_fits_int16`) runs the SW DP
    — scores, gap carries, the scan, byte offsets, best and end — in
    ``torch.int16``, as the reference's int16 ``acc`` does: a scoring past
    the bound would show as a wrapped result, not pass silently."""
    (match_score, mismatch, gap_open, gap_ext, prefix_b, cap_b, case_b,
     exact_b, delim_b) = (int(s) for s in scoring)
    gop_extra = max(gap_open - gap_ext, 0)
    R, W = hay_in.shape
    S = W
    BIG = S + 1
    i32 = torch.int32
    acc = torch.int16 if int16_lanes else i32
    if int16_lanes:
        mismatch = min(mismatch, INT16_SCORE_LIMIT)
    hay, valid, col, (fb, prev_b, boff, blen, n_bytes) = _unit_grid(
        hay_in, nu)
    dev = hay_in.device
    zero = torch.zeros(R, dtype=i32, device=dev)

    matched, wstart_raw, wend, _nb = _prefilter(
        hay, valid, col, boff, blen, n_bytes, orig, flip, n=n, T=T,
        no_prefilter=no_prefilter)

    def const(mask, v):
        # v where mask holds, else 0, in the DP's lane type
        return torch.where(mask, torch.tensor(v, dtype=acc, device=dev),
                           torch.tensor(0, dtype=acc, device=dev))

    # ---- windowed affine-gap Smith-Waterman, start-1 trim
    wstart = torch.clamp(wstart_raw - 1, min=0)
    include_exact = (wstart == 0) & (wend == n_bytes)
    hay_a, boff_a, blen_a = hay.to(acc), boff.to(acc), blen.to(acc)
    wstart_a, wend_a = wstart.to(acc), wend.to(acc)
    active = _window_active(valid, boff_a, blen_a, wstart_a, wend_a)
    first_unit = _lane_min(torch.where(active, col, BIG))
    is_first = active & (col == first_unit[:, None])
    cap_mask = is_upper(fb) & is_lower(prev_b) & ~is_first
    delim_mask = is_delim(prev_b) & ~is_delim(fb) & ~is_first
    bonus = (const(cap_mask, cap_b) + const(delim_mask, delim_b)
             + const(is_first & (wstart == 0)[:, None], prefix_b))
    prev_row = torch.zeros((R, W), dtype=acc, device=dev)
    prev_mm = torch.zeros((R, W), dtype=torch.bool, device=dev)
    neq = torch.zeros(R, dtype=torch.bool, device=dev)
    for k in range(n):
        match = active & ((hay_a == orig[k]) | (hay_a == flip[k]))
        exactc = active & (hay_a == orig[k])
        diag_base = _shift_right(prev_row, 0)
        diag = torch.where(
            match,
            diag_base + match_score + bonus + const(exactc, case_b),
            torch.clamp(diag_base - mismatch, min=0),
        )
        up = torch.clamp(prev_row - gap_ext - const(prev_mm, gop_extra),
                         min=0)
        c = torch.maximum(diag, up)
        p = gap_ext + const(match, gop_extra)
        q = _shift_right(torch.cumsum(p, dim=1, dtype=acc), 0)
        prev_row = torch.cummax(c + q, dim=1).values - q
        # exact: haystack unit k against needle unit k, case-sensitive
        hk = hay[:, k] if k < W else zero
        neq = neq | (hk != orig[k])
        prev_mm = match
    prev_row = torch.where(active, prev_row, 0)
    score = torch.clamp(_lane_max(prev_row), min=0)
    end_unit = _lane_min(torch.where(prev_row == score[:, None], col, BIG))
    end_b = _lane_gather(boff_a, torch.clamp(end_unit, max=S - 1))
    end_col = torch.where(score > 0, end_b, wstart_a).to(i32)
    score = score.to(i32)
    exact = include_exact & (nu == n) & ~neq
    score = torch.where(exact, torch.clamp(score + exact_b, max=0xFFFF),
                        score)
    greedy = matched & ((wend - wstart) > MAX_HAYSTACK_LEN)
    return (matched.to(i32), score.to(i32), exact.to(i32), end_col.to(i32),
            greedy.to(i32))


def match_units_plain(
    cp, n_units, scalars, rows=None, idx=None, *, n: int, max_typos: int = 0,
    scoring, no_prefilter: bool = False, idx_bits: int = 0,
    int16_lanes: bool = False,
):
    """Plain PyTorch version of :func:`match_units`: a loop over queries,
    each running :func:`_match_rows_plain` on its live rows."""
    B, W = cp.shape
    if int16_lanes:
        check_int16_lanes(cp.dtype != torch.int8, scoring, n, W)
    Q = scalars.shape[0]
    nu = n_units.reshape(-1)
    T = min(int(max_typos), n)
    dev = cp.device
    if idx is None:
        out = torch.zeros((Q, B, 8), dtype=torch.int32, device=dev)
    else:
        out = torch.full((Q, B), INT64_MAX, dtype=torch.int64, device=dev)
    sc = scalars.cpu()
    for q in range(Q):
        count = max(0, min(int(sc[q, 0]), B))
        if count == 0:
            continue
        if rows is None:
            sel = torch.arange(count, device=dev)
        else:
            sel = rows[q, :count].to(torch.int64)
        orig = sc[q, 2:2 + n].tolist()
        flip = sc[q, 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n].tolist()
        cols = _match_rows_plain(
            cp[sel], nu[sel], orig, flip, n=n, T=T, scoring=scoring,
            no_prefilter=no_prefilter, int16_lanes=int16_lanes,
        )
        if idx is None:
            out[q, :count, :5] = torch.stack(cols, dim=1)
        else:
            out[q, :count] = pack_keys(*cols, idx[sel], idx_bits)
    return out


def match_units(
    cp, n_units, scalars, rows=None, idx=None, *, n: int, max_typos: int = 0,
    scoring, no_prefilter: bool = False, idx_bits: int = 0,
    int16_lanes: bool = False,
):
    """Row-major fused prefilter + Smith-Waterman for Q queries over one
    bucket in one launch (grid = row blocks x queries).

    cp (B, W) int8 bytes or int32 codepoints, n_units (B,) int32,
    scalars (Q, 130) int32 (:func:`pack_needle_scalars`; [q, 0] is query
    q's live count).
    ``rows`` (Q, B) int32, when given, is each query's row order: logical
    row i of query q is bucket row ``rows[q, i]`` (the serving flow puts
    stage-1 survivors first); without it logical row i is row i. Only
    logical rows below the live count are matched; the rest are zero.

    Returns (Q, B, 8) int32 columns per logical row — matched, score,
    exact, end_col, greedy, 0, 0, 0 (``frizbee_tpu``'s ``match_units``
    layout) — or, when ``idx`` (B,) int32 corpus indices is given, (Q, B)
    int64 serving keys (:func:`pack_keys`; INT64_MAX past the count).

    ``int16_lanes`` selects the int16-lane instantiation (byte rows where
    :func:`score_fits_int16` holds, else ValueError): the same results,
    counted in ``_build.LAUNCHES["match_units_i16"]``."""
    if cp.device.type == "cpu":
        return match_units_plain(
            cp, n_units, scalars, rows, idx, n=n, max_typos=max_typos,
            scoring=scoring, no_prefilter=no_prefilter, idx_bits=idx_bits,
            int16_lanes=int16_lanes,
        )
    if cp.device.type != "cuda":
        raise ValueError(f"unsupported device {cp.device}")
    T = min(int(max_typos), n)
    if not 1 <= n <= MAX_KERNEL_NEEDLE or T > MAX_KERNEL_TYPOS:
        raise ValueError(f"needle length {n} / typo budget {T} out of range")
    B, W = cp.shape
    Q = scalars.shape[0]
    unicode = cp.dtype != torch.int8
    if int16_lanes:
        check_int16_lanes(unicode, scoring, n, W)
    if W % 4 or W > MAX_HAYSTACK_LEN or cp.data_ptr() % 4:
        raise ValueError(f"row-major kernel wants a 4-byte aligned width "
                         f"<= {MAX_HAYSTACK_LEN}, got {W}")
    n_units = n_units.reshape(-1)
    _build.check_operands(cp.device, (
        ("cp", cp, torch.int32 if unicode else torch.int8, (B, W)),
        ("n_units", n_units, torch.int32, (B,)),
        ("scalars", scalars, torch.int32, (Q, 2 + 2 * MAX_KERNEL_NEEDLE)),
        ("rows", rows, torch.int32, (Q, B)),
        ("idx", idx, torch.int32, (B,)),
    ))
    keys = cols = None
    if idx is not None:
        keys = torch.empty((Q, B), dtype=torch.int64, device=cp.device)
    else:
        cols = torch.empty((Q, B, 8), dtype=torch.int32, device=cp.device)
    _sc, sc_ptr = _build.scoring_arg(scoring)
    _build.launch(
        "match_units", cp.device,
        _build.ptr(cp), _build.ptr(n_units), _build.ptr(scalars),
        _build.ptr(rows), _build.ptr(idx), Q, B, W, n, T,
        prefilter_mode(n, T, no_prefilter), int(unicode), int(int16_lanes),
        sc_ptr, idx_bits, _build.ptr(keys), _build.ptr(cols),
        _build.stream(cp),
        call=((cp, n_units, scalars, rows, idx),
              dict(n=n, max_typos=max_typos, scoring=scoring,
                   no_prefilter=no_prefilter, idx_bits=idx_bits,
                   int16_lanes=int16_lanes)),
        count="match_units_i16" if int16_lanes else None,
    )
    return keys if keys is not None else cols


def _survivor_order(s1, nu, W):
    """(Q, B) int32 row order per query: stage-1 survivors first, each
    part by (unit count, row) — one sort of packed [reject | n_units |
    row] keys (``survivor_perms`` in the reference), so survivors of
    similar length share warps."""
    Q, B = s1.shape
    bbits = max((B - 1).bit_length(), 1)
    wbits = W.bit_length()
    # holds for every bucket pack_corpus builds (corpus.max_bucket_rows)
    assert bbits + wbits + 1 <= 31, (B, W)
    iota = torch.arange(B, dtype=torch.int32, device=s1.device)
    keyb = (nu << bbits) | iota
    key = torch.where(s1, keyb, keyb | (1 << (bbits + wbits)))
    # a transposed mask carries its strides through where and sort
    return (torch.sort(key, dim=1).values & ((1 << bbits) - 1)).contiguous()


def fuzzy_match_units(cp, n_units, needle_packed, *, max_typos: int = 0,
                      no_prefilter: bool = False, scoring=DEFAULT_SCORING,
                      survivors=None):
    """Full fused fuzzy match of a bucket: the stage-1 presence reject,
    then :func:`match_units` in columns mode over each query's survivors
    (through a survivor order and a live count, in place of the
    reference's compaction and capacity switch), then the columns back
    in bucket row order.

    cp (B, W) int8 bytes or int32 codepoints (W a divisor or multiple of
    128, at most 1024), n_units (B,) or (B, 1), ``needle_packed`` (2n,)
    or (Q, 2n) int32: orig then flip. Returns (matched bool, score int32,
    exact bool, end_col int32, greedy bool), each (B,), or (Q, B) for
    (Q, 2n) needles; every column is zero (False) where matched is
    False. The int16-lane instantiation serves the rows where
    :func:`int16_lanes_dispatch` holds, as the reference's ``(not
    unicode) and score_fits_int16(...) and (interpret or
    INT16_MOSAIC_OK)`` does.

    Stage 1 runs when the DP is conditional (``no_prefilter`` false and
    n > T) and the caller gives ``survivors``, a (B,) or (Q, B) bool
    stage-1 mask: the reference's per-row per-character
    ``presence.stage1_presence``, or the capped-count matmul of
    ``presence.presence_hits`` over the resident presence planes (the
    batch flows, one matmul for all Q). Either is a sound superset of
    the kernel's own prefilter, so the result equals the kernel over
    every row; it is ANDed into ``matched`` as the reference does."""
    B, W = cp.shape
    single = needle_packed.dim() == 1
    needles = needle_packed.reshape(-1, needle_packed.shape[-1]).to(
        torch.int32)
    Q, n2 = needles.shape
    n = n2 // 2
    assert (W % 128 == 0 or 128 % W == 0) and W <= MAX_HAYSTACK_LEN, W
    assert 1 <= n <= MAX_KERNEL_NEEDLE, n
    T = min(int(max_typos), n)
    int16 = int16_lanes_dispatch(cp.device, cp.dtype != torch.int8,
                                 scoring, n, W)
    nu = n_units.reshape(-1)
    scal = pack_needle_scalars(needles, B)
    s1 = order = None
    if survivors is not None and not no_prefilter and n > T:
        s1 = survivors.reshape(Q, B)
        scal[:, 0] = s1.sum(dim=1, dtype=torch.int32)
        order = _survivor_order(s1, nu, W)
    out = match_units(cp, nu, scal, order, None, n=n, max_typos=T,
                      scoring=scoring, no_prefilter=no_prefilter,
                      int16_lanes=int16)
    if order is not None:
        # logical row i of query q is bucket row order[q, i]; rows past
        # the live count came back zero
        out = torch.zeros_like(out).scatter_(
            1, order.to(torch.int64)[:, :, None].expand(Q, B, 8), out)
    matched = out[..., 0] > 0
    if s1 is not None:
        matched = matched & s1
    score = torch.where(matched, out[..., 1], 0)
    exact = matched & (out[..., 2] > 0)
    end_col = torch.where(matched, out[..., 3], 0)
    greedy = matched & (out[..., 4] > 0)
    res = (matched, score, exact, end_col, greedy)
    return tuple(r[0] for r in res) if single else res
