"""Scalar Smith-Waterman oracle with affine gaps and the 5-bonus schedule.

Semantics contract (reference: src/smith_waterman/algo/ascii.rs:10-158,
src/smith_waterman/algo/unicode.rs:10-217, canonicalized to sequential gap
propagation — see oracle/__init__.py):

For needle row ``i`` (1-based) and haystack unit ``j`` (1-based), in u16
saturating arithmetic:

  diag  = H[i-1][j-1] (+ match_score + bonus[j] if match) -sat mismatch
          (+ matching_case_bonus if exact-case match)
  up    = H[i-1][j] -sat gap_extend -sat (gap_open' if MM[i-1][j])
  left  = H[i][j-1] -sat (gap_extend + (gap_open' if MM[i][j-1]))
  H[i][j] = max(diag, up, left)

where ``gap_open' = sat(gap_open - gap_extend)`` (the pre-bias at
src/smith_waterman/algo/ascii.rs:36-40), ``bonus[j]`` sums the
capitalization/delimiter/prefix bonuses derived from unit ``j``'s first byte
and unit ``j-1``'s last byte, and MM is the (case-insensitive) match mask.

Final score = max over j of H[needle_len][j].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..config import Scoring, sat_sub_u16, sat_add_u16, U16_MAX
from .tokenize import (
    HayUnits,
    NeedleUnits,
    is_ascii_lower,
    is_ascii_upper,
    is_delimiter,
)


def unit_bonus(hay: HayUnits, j: int, include_prefix: bool, scoring: Scoring) -> int:
    """Match-conditional bonus for haystack unit ``j`` (0-based)."""
    bonus = 0
    fb = hay.first_byte[j]
    pb = hay.prev_last_byte[j]
    if is_ascii_upper(fb) and is_ascii_lower(pb):
        bonus += scoring.capitalization_bonus
    if is_delimiter(pb) and not is_delimiter(fb):
        bonus += scoring.delimiter_bonus
    if include_prefix and j == 0:
        bonus += scoring.prefix_bonus
    return bonus


def sw_matrices(
    needle: NeedleUnits,
    hay: HayUnits,
    scoring: Scoring,
    include_prefix: bool,
) -> Tuple[List[List[int]], List[List[bool]]]:
    """Fill the (n+1) x (m+1) score matrix and match-mask matrix."""
    n = len(needle.orig)
    m = len(hay.cp)
    gap_ext = scoring.gap_extend_penalty
    gap_open_extra = sat_sub_u16(scoring.gap_open_penalty, gap_ext)

    H = [[0] * (m + 1) for _ in range(n + 1)]
    MM = [[False] * (m + 1) for _ in range(n + 1)]

    bonuses = [unit_bonus(hay, j, include_prefix, scoring) for j in range(m)]

    for i in range(1, n + 1):
        n_orig = needle.orig[i - 1]
        n_flip = needle.flip[i - 1]
        row = H[i]
        prev_row = H[i - 1]
        prev_mm = MM[i - 1]
        mm = MM[i]
        for j in range(1, m + 1):
            h_cp = hay.cp[j - 1]
            exact_case = h_cp == n_orig
            match = exact_case or h_cp == n_flip
            mm[j] = match

            # Diagonal (reference: src/smith_waterman/algo/ascii.rs:116-128)
            diag = prev_row[j - 1]
            if match:
                diag = sat_add_u16(
                    diag,
                    scoring.match_score + scoring.mismatch_penalty + bonuses[j - 1],
                )
            diag = sat_sub_u16(diag, scoring.mismatch_penalty)
            if exact_case:
                diag = sat_add_u16(diag, scoring.matching_case_bonus)

            # Up: skipping a needle unit (reference: ascii.rs:130-134)
            up = sat_sub_u16(prev_row[j], gap_ext)
            if prev_mm[j]:
                up = sat_sub_u16(up, gap_open_extra)

            # Left: skipping a haystack unit, sequential affine propagation
            left_penalty = gap_ext + (gap_open_extra if mm[j - 1] else 0)
            left = sat_sub_u16(row[j - 1], left_penalty)

            row[j] = max(diag, up, left)

    return H, MM


def sw_score(
    needle: NeedleUnits,
    hay: HayUnits,
    scoring: Scoring,
    include_prefix: bool,
) -> int:
    n = len(needle.orig)
    if n == 0:
        return 0
    H, _ = sw_matrices(needle, hay, scoring, include_prefix)
    return max(H[n]) if H[n] else 0


def match_end_col(H: List[List[int]], hay: HayUnits) -> int:
    """Byte offset where the best alignment ends: first final-row column
    holding the row max, reported at the unit's start byte
    (reference: src/smith_waterman/algo/mod.rs:166-198, start-byte
    reporting pinned by the `test_end_col_unicode` test)."""
    final = H[-1]
    if len(final) <= 1:
        return 0
    best = max(final[1:])
    for j in range(1, len(final)):
        if final[j] == best:
            return hay.byte_off[j - 1]
    return 0


def sw_indices(
    needle: NeedleUnits,
    hay: HayUnits,
    scoring: Scoring,
    include_prefix: bool,
    max_typos: Optional[int],
    haystack_start_pos: int = 0,
) -> Tuple[int, List[int]]:
    """Score + matched byte offsets in reverse order, via alignment traceback
    (reference: src/smith_waterman/alignment_iter.rs:112-181,
    src/smith_waterman/algo/mod.rs:49-158).

    Exceeding the typo budget truncates the indices but keeps the score,
    matching `score_haystack_indices`' early break.
    """
    n = len(needle.orig)
    if n == 0:
        return 0, []
    H, MM = sw_matrices(needle, hay, scoring, include_prefix)
    m = len(hay.cp)
    score = max(H[n]) if m else 0
    if score == 0:
        return 0, []

    # Start column: first final-row column holding the score
    col = next(j for j in range(1, m + 1) if H[n][j] == score)
    row = n
    cur_score = score
    typo_count = 0
    indices: List[int] = []

    while row > 0:
        if max_typos is not None and typo_count > max_typos:
            break  # budget exceeded: truncate (reference None => break)
        if col < 1 or cur_score == 0:
            # left edge or lost alignment; remaining rows count as typos
            # (reference: alignment_iter.rs:127-135). Either way, iteration
            # ends and the collected indices stand.
            break
        if MM[row][col]:
            unit = col - 1
            # Expand the matched unit to its byte offsets, reversed
            off = hay.byte_off[unit] + haystack_start_pos
            for b in range(hay.byte_len[unit] - 1, -1, -1):
                indices.append(off + b)
            row -= 1
            col -= 1
            cur_score = H[row][col]
            continue
        diag = H[row - 1][col - 1]
        left = H[row][col - 1]
        up = H[row - 1][col]
        if diag >= left and diag >= up:
            row -= 1
            col -= 1
            typo_count += 1
            cur_score = diag
        elif left >= up:
            col -= 1
            cur_score = left
        else:
            row -= 1
            typo_count += 1
            cur_score = up

    return score, indices


def sw_has_alignment(
    needle: NeedleUnits,
    hay: HayUnits,
    scoring: Scoring,
    include_prefix: bool,
    max_typos: int,
) -> bool:
    """True when an alignment within the typo budget exists (test helper,
    reference: src/smith_waterman/alignment.rs:26-36)."""
    n = len(needle.orig)
    if n == 0:
        return True
    H, MM = sw_matrices(needle, hay, scoring, include_prefix)
    m = len(hay.cp)
    score = max(H[n]) if m else 0
    if score == 0:
        # The walk stops immediately on a zero score: all needle rows count
        # as typos (reference: alignment_iter.rs:127-135)
        return n <= max_typos

    col = next(j for j in range(1, m + 1) if H[n][j] == score)
    row = n
    cur_score = score
    typo_count = 0
    while row > 0:
        if typo_count > max_typos:
            return False
        if col < 1 or cur_score == 0:
            return typo_count + row <= max_typos
        if MM[row][col]:
            row -= 1
            col -= 1
            cur_score = H[row][col]
            continue
        diag = H[row - 1][col - 1]
        left = H[row][col - 1]
        up = H[row - 1][col]
        if diag >= left and diag >= up:
            row -= 1
            col -= 1
            typo_count += 1
            cur_score = diag
        elif left >= up:
            col -= 1
            cur_score = left
        else:
            row -= 1
            typo_count += 1
            cur_score = up
    return typo_count <= max_typos
