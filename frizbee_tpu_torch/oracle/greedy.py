"""Greedy linear-time fallback for haystacks longer than MAX_HAYSTACK_LEN.

Byte-level (even for unicode needles) first-match scan with the same bonus
schedule and per-run affine gap penalty (reference:
src/smith_waterman/greedy.rs:7-91). Note the greedy path's delimiter bonus is
gated on having seen a non-delimiter char first, which the matrix path does
not do — a documented divergence in the reference itself.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..casefold import case_needle_bytes
from ..config import Scoring, sat_add_u16, sat_mul_u16, sat_sub_u16
from .tokenize import is_ascii_digit, is_ascii_lower, is_ascii_upper


def match_greedy(
    needle: bytes,
    haystack: bytes,
    scoring: Scoring,
    case_sensitive: bool,
    include_prefix: bool,
) -> Optional[Tuple[int, List[int]]]:
    pairs = case_needle_bytes(needle, case_sensitive)
    if len(pairs) > len(haystack):
        return None

    score = 0
    indices: List[int] = []
    haystack_idx = 0

    delimiter_bonus_enabled = False
    prev_is_lower = False
    prev_is_delimiter = False

    for needle_idx, (n_orig, n_flip) in enumerate(pairs):
        haystack_start_idx = haystack_idx
        found = False
        limit = len(haystack) - len(pairs) + needle_idx
        while haystack_idx <= limit:
            h = haystack[haystack_idx]
            h_digit = is_ascii_digit(h)
            h_upper = is_ascii_upper(h)
            h_lower = is_ascii_lower(h)
            h_delim = h <= 127 and not (h_lower or h_upper or h_digit)

            if not h_delim:
                delimiter_bonus_enabled = True

            if h != n_orig and h != n_flip:
                prev_is_delimiter = delimiter_bonus_enabled and h_delim
                prev_is_lower = h_lower
                haystack_idx += 1
                continue

            score = sat_add_u16(score, scoring.match_score)

            if haystack_idx != haystack_start_idx and needle_idx != 0:
                gap_len = max(haystack_idx - haystack_start_idx - 1, 0)
                gap_len = min(gap_len, 0xFFFF)
                score = sat_sub_u16(
                    score,
                    sat_add_u16(
                        scoring.gap_open_penalty,
                        sat_mul_u16(scoring.gap_extend_penalty, gap_len),
                    ),
                )

            if h == n_orig:
                score = sat_add_u16(score, scoring.matching_case_bonus)
            if h_upper and prev_is_lower:
                score = sat_add_u16(score, scoring.capitalization_bonus)
            if include_prefix and haystack_idx == 0:
                score = sat_add_u16(score, scoring.prefix_bonus)
            if prev_is_delimiter and not h_delim:
                score = sat_add_u16(score, scoring.delimiter_bonus)

            prev_is_delimiter = delimiter_bonus_enabled and h_delim
            prev_is_lower = h_lower

            indices.append(haystack_idx)
            haystack_idx += 1
            found = True
            break

        if not found:
            return None

    return score, indices
