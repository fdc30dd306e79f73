"""The generic fuzzy pipeline over one packed bucket: the typo-budget
prefilter, the start-1 trim, Smith-Waterman and the exact bonus, as
plain PyTorch ops on (B, W) unit planes (``PackedBucket.device_arrays``).

Counterpart of ``frizbee_tpu/ops/fuzzy.py``, which is plain XLA there
too: it serves what the match kernels do not take (needles over 64
units, typo budgets over 8, bucket widths the kernels do not hold) and
the engines' per-pattern ``match_corpus``. One row per haystack, unit
columns: the left gap propagation of the DP is an exact max-plus prefix
scan, ``left[j] = cummax(C + Q)[j] - Q[j]`` with ``Q`` the exclusive
cumsum of per-column gap costs. Integer sums carry ``dtype=torch.int32``
(torch promotes int32 sums to int64 otherwise).
"""

from __future__ import annotations

import torch

from ..config import MAX_HAYSTACK_LEN

# Scoring vector layout (int32, shape (9,)):
#   0 match, 1 mismatch, 2 gap_open, 3 gap_extend, 4 prefix,
#   5 capitalization, 6 matching_case, 7 exact, 8 delimiter
SCORING_FIELDS = (
    "match_score",
    "mismatch_penalty",
    "gap_open_penalty",
    "gap_extend_penalty",
    "prefix_bonus",
    "capitalization_bonus",
    "matching_case_bonus",
    "exact_match_bonus",
    "delimiter_bonus",
)


def scoring_vector(scoring, device=None) -> torch.Tensor:
    """(9,) int32 scoring vector of a ``Scoring`` in SCORING_FIELDS order."""
    return torch.tensor([int(getattr(scoring, f)) for f in SCORING_FIELDS],
                        dtype=torch.int32, device=device)


def _cols(B: int, W: int, device) -> torch.Tensor:
    return torch.arange(W, dtype=torch.int32, device=device).expand(B, W)


def _first_occurrence(occ, cols, big: int) -> torch.Tensor:
    """Smallest column index where occ is True, else ``big``. (B,)"""
    return torch.where(occ, cols, big).amin(dim=1)


def _next_occurrence(occ, pos, cols, big: int) -> torch.Tensor:
    """Smallest column >= pos where occ is True, else ``big``. (B,)"""
    return torch.where(occ & (cols >= pos[:, None]), cols, big).amin(dim=1)


def _last_occurrence(occ, cols) -> torch.Tensor:
    """Largest column where occ is True, else -1. (B,)"""
    return torch.where(occ, cols, -1).amax(dim=1)


def _first_true(mask, cols) -> torch.Tensor:
    """Column of the first True per row, 0 where there is none (argmax
    over a bool row: the first maximum)."""
    W = mask.shape[1]
    first = torch.where(mask, cols, W).amin(dim=1)
    return torch.where(first < W, first, 0)


def _take(x, idx) -> torch.Tensor:
    """x[r, idx[r]] of (B, W) x."""
    return x.gather(1, idx[:, None].to(torch.int64))[:, 0]


def prefilter_bucket(cp, byte_off, byte_len, n_units, n_bytes, needle_orig,
                     needle_flip, max_typos: int):
    """Typo-tolerant ordered-subsequence prefilter + window over a bucket.

    Semantics contract: oracle/prefilter.py. ``needle_orig`` and
    ``needle_flip`` are (n,) int32 tensors or int lists. Returns (matched
    (B,) bool, wstart_byte (B,) int32, wend_byte (B,) int32) with the
    untrimmed window (the caller applies the start-1 trim)."""
    B, W = cp.shape
    orig, flip = _units(needle_orig), _units(needle_flip)
    n = len(orig)
    T = int(max_typos)
    BIG = W + 1
    dev = cp.device
    i32 = torch.int32

    if n <= T:
        # a needle no longer than the typo budget matches everything
        # (reference: src/prefilter/algo/ascii_typos.rs:263-267)
        return (torch.ones(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=i32, device=dev), n_bytes.to(i32))

    cols = _cols(B, W, dev)
    valid = cols < n_units[:, None]

    def occ_of(k):
        return valid & ((cp == orig[k]) | (cp == flip[k]))

    # minimal-position DP over the typo budget: f[t] = minimal units
    # consumed to match the needle prefix with <= t deletions
    f = [torch.zeros(B, dtype=i32, device=dev) for _ in range(T + 1)]
    first_occ_start = torch.full((B,), BIG, dtype=i32, device=dev)
    start_unit_zero_typo = torch.zeros(B, dtype=i32, device=dev)
    for k in range(n):
        occ = occ_of(k)
        if k <= T:
            # window start (typo case): the first occurrence among the
            # first T+1 needle units
            first_occ_start = torch.minimum(
                first_occ_start, _first_occurrence(occ, cols, BIG))
        nf = []
        for t in range(T + 1):
            nxt = torch.where(
                f[t] <= W,
                torch.clamp(_next_occurrence(occ, f[t], cols, BIG) + 1,
                            max=BIG),
                BIG,
            )
            if t > 0:
                nxt = torch.minimum(nxt, f[t - 1])
            nf.append(nxt)
        if k == 0:
            start_unit_zero_typo = torch.clamp(nf[0] - 1, max=W)
        f = nf

    matched = f[T] <= W

    if T == 0:
        # start = greedy first hit of needle[0]; end = one past the last
        # occurrence of the final needle unit at/after the greedy
        # completion
        last_pos = f[0] - 1
        e = _last_occurrence(occ_of(n - 1) & (cols >= last_pos[:, None]),
                             cols)
        e_c = torch.clamp(e, 0, W - 1)
        wstart = _take(byte_off, torch.clamp(start_unit_zero_typo, 0, W - 1))
    else:
        start_u = torch.clamp(first_occ_start, 0, W - 1)
        wstart = torch.where(first_occ_start <= W, _take(byte_off, start_u),
                             0)
        occ_tail = torch.zeros((B, W), dtype=torch.bool, device=dev)
        for k in range(max(n - 1 - T, 0), n):
            occ_tail = occ_tail | occ_of(k)
        e = _last_occurrence(occ_tail, cols)
        e_c = torch.clamp(e, 0, W - 1)
    wend = torch.where(e >= 0, _take(byte_off, e_c) + _take(byte_len, e_c),
                       n_bytes)
    wstart = torch.where(matched, wstart, 0)
    wend = torch.where(matched, wend, n_bytes)
    return matched, wstart.to(i32), wend.to(i32)


def _units(x):
    """Needle units: ints, or 0-d tensors of a card tensor (no sync)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return list(x.to(torch.int32).unbind())
        return [int(v) for v in x.to(torch.int64).tolist()]
    return [int(v) for v in x]


def _ints(x):
    """A scoring vector (tensor or sequence) as ints."""
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.to(torch.int64).cpu().tolist()]
    return [int(v) for v in x]


def _shift_right(x):
    """Columns one to the right, column 0 = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _sel(mask, v: int) -> torch.Tensor:
    """int32 ``v`` where mask holds, else 0."""
    return mask.to(torch.int32) * v


def _delim(b):
    letter = ((b >= 0x41) & (b <= 0x5A)) | ((b >= 0x61) & (b <= 0x7A))
    digit = (b >= 0x30) & (b <= 0x39)
    return (b >= 0) & (b <= 127) & ~letter & ~digit


def sw_score_bucket(cp, first_byte, prev_last_byte, byte_off, byte_len,
                    n_units, wstart, wend, needle_orig, needle_flip, sc):
    """Smith-Waterman scores and end columns over a window-masked bucket.

    Semantics contract: oracle/smith_waterman.py. ``sc`` is the (9,)
    scoring vector (a tensor or a sequence). Returns (score (B,) int32,
    end_col (B,) int32 absolute byte offset)."""
    B, W = cp.shape
    dev = cp.device
    i32 = torch.int32
    orig, flip = _units(needle_orig), _units(needle_flip)
    (match_score, mismatch, gap_open, gap_ext, prefix_b, cap_b, case_b,
     _exact_b, delim_b) = _ints(sc)
    gop_extra = max(gap_open - gap_ext, 0)
    cols = _cols(B, W, dev)
    valid = cols < n_units[:, None]

    # window mask in unit space: a unit takes part when fully inside the
    # byte window
    active = (valid & (byte_off >= wstart[:, None])
              & (byte_off + byte_len <= wend[:, None]))
    # first window unit: no capitalization/delimiter bonus (its context
    # byte is outside the window); prefix bonus only when the window
    # starts at byte 0 (reference: src/matcher/algo.rs:332-338)
    first_unit_idx = _first_true(active, cols)
    is_first = active & (cols == first_unit_idx[:, None])
    include_prefix = (wstart == 0)[:, None]

    fb, pb = first_byte, prev_last_byte
    is_upper = (fb >= 0x41) & (fb <= 0x5A)
    prev_lower = (pb >= 0x61) & (pb <= 0x7A)
    cap_mask = is_upper & prev_lower & ~is_first
    delim_mask = _delim(pb) & ~_delim(fb) & ~is_first
    bonus = (_sel(cap_mask, cap_b) + _sel(delim_mask, delim_b)
             + _sel(is_first & include_prefix, prefix_b))

    row = torch.zeros((B, W), dtype=i32, device=dev)
    prev_mm = torch.zeros((B, W), dtype=torch.bool, device=dev)
    for n_o, n_f in zip(orig, flip):
        match = active & ((cp == n_o) | (cp == n_f))
        exactc = active & (cp == n_o)
        diag_base = _shift_right(row)
        diag = torch.where(
            match,
            diag_base + match_score + bonus + _sel(exactc, case_b),
            torch.clamp(diag_base - mismatch, min=0),
        )
        up = torch.clamp(row - gap_ext - _sel(prev_mm, gop_extra), min=0)
        c = torch.maximum(diag, up)
        # exact max-plus prefix scan of the sequential left propagation
        p = gap_ext + _sel(match, gop_extra)
        q = _shift_right(torch.cumsum(p, dim=1, dtype=i32))
        row = torch.cummax(c + q, dim=1).values - q
        prev_mm = match

    # lanes past the window accumulate mismatch-decayed values that can
    # exceed the true in-window max: mask them out of the result
    row = torch.where(active, row, 0)
    score = torch.clamp(row.amax(dim=1), min=0)
    # end column: the first column holding the max, at the unit's start
    # byte; a zero score degrades to the window start
    end_unit = _first_true(row == score[:, None], cols)
    end_col = torch.where(score > 0, _take(byte_off, end_unit), wstart)
    return score.to(i32), end_col.to(i32)


def fuzzy_pipeline(cp, first_byte, prev_last_byte, byte_off, byte_len,
                   n_units, n_bytes, needle_orig, needle_flip, sc, *,
                   max_typos: int = 0, no_prefilter: bool = False):
    """Full fuzzy pipeline for one bucket: prefilter -> trim -> SW ->
    exact.

    Returns (matched, score, exact, end_col, needs_greedy, wstart_trimmed,
    wend), all (B,). Rows flagged ``needs_greedy`` (trimmed window longer
    than MAX_HAYSTACK_LEN bytes) carry no valid score: the host greedy
    path rescores them (reference: src/smith_waterman/algo/ascii.rs)."""
    B, W = cp.shape
    dev = cp.device
    i32 = torch.int32
    orig, flip = _units(needle_orig), _units(needle_flip)
    sc = _ints(sc)
    n = len(orig)
    n_bytes = n_bytes.to(i32)

    if no_prefilter:
        matched = torch.ones(B, dtype=torch.bool, device=dev)
        wstart_raw = torch.zeros(B, dtype=i32, device=dev)
        wend = n_bytes
    else:
        matched, wstart_raw, wend = prefilter_bucket(
            cp, byte_off, byte_len, n_units, n_bytes, orig, flip, max_typos)

    # trim: back up one byte to keep the delimiter-bonus context
    wstart = torch.clamp(wstart_raw - 1, min=0)
    include_exact = (wstart == 0) & (wend == n_bytes)
    needs_greedy = matched & ((wend - wstart) > MAX_HAYSTACK_LEN)

    score, end_col = sw_score_bucket(
        cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
        wstart, wend, orig, flip, sc)

    # exact: full-window coverage and byte equality with the needle
    # (case-sensitive; reference: src/matcher/algo.rs:245-248)
    if n <= W:
        needle = (torch.stack(orig) if isinstance(orig[0], torch.Tensor)
                  else torch.tensor(orig, dtype=torch.int32, device=dev))
        eq_units = (cp[:, :n] == needle[None, :]).all(dim=1)
        exact = include_exact & (n_units == n) & eq_units
    else:
        exact = torch.zeros(B, dtype=torch.bool, device=dev)
    score = torch.where(exact, torch.clamp(score + sc[7], max=0xFFFF), score)
    return (matched, score.to(i32), exact, end_col, needs_greedy,
            wstart.to(i32), wend.to(i32))


# The engines' entry point; JAX jits it, torch runs it eagerly
fuzzy_match_bucket = fuzzy_pipeline

