"""Literal matching oracle: exact / prefix / suffix / substring.

Contiguous-run matching with the same per-char bonus schedule as
Smith-Waterman; ``max_typos`` is ignored (reference: src/literal/algo.rs).
Substring picks the highest-scoring occurrence, preferring earlier positions
on ties (reference: src/literal/algo.rs:262-313).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..casefold import case_needle_bytes, case_needle_unicode
from ..config import Matching, Scoring, sat_add_u16
from .tokenize import is_ascii_lower, is_ascii_upper, is_delimiter


def _needle_variants(
    needle: str, unicode: bool, case_sensitive: bool
) -> List[Tuple[bytes, bytes]]:
    """Per-unit (orig_bytes, flipped_bytes)."""
    if unicode:
        return [
            (o.encode("utf-8"), f.encode("utf-8"))
            for o, f in case_needle_unicode(needle, case_sensitive)
        ]
    return [
        (bytes([o]), bytes([f]))
        for o, f in case_needle_bytes(needle.encode("utf-8"), case_sensitive)
    ]


def _matches_at(units: List[Tuple[bytes, bytes]], haystack: bytes, pos: int) -> bool:
    k = pos
    for orig, flip in units:
        chunk = haystack[k : k + len(orig)]
        if chunk != orig and chunk != flip:
            return False
        k += len(orig)
    return True


def _score_at(
    units: List[Tuple[bytes, bytes]],
    haystack: bytes,
    pos: int,
    needle_len: int,
    scoring: Scoring,
) -> int:
    score = 0
    start = pos
    for orig, _flip in units:
        exact_case = haystack[start : start + len(orig)] == orig
        s = scoring.match_score
        if exact_case:
            s += scoring.matching_case_bonus
        if start == 0:
            s += scoring.prefix_bonus
        else:
            byte = haystack[start]
            prev = haystack[start - 1]
            if is_ascii_upper(byte) and is_ascii_lower(prev):
                s += scoring.capitalization_bonus
            if is_delimiter(prev) and not is_delimiter(byte):
                s += scoring.delimiter_bonus
        score = sat_add_u16(score, s)
        start += len(orig)
    if pos == 0 and needle_len == len(haystack):
        score = sat_add_u16(score, scoring.exact_match_bonus)
    return score


def literal_find(
    needle: str,
    haystack: bytes,
    mode: Matching,
    unicode: bool,
    case_sensitive: bool,
    scoring: Scoring,
) -> Optional[Tuple[int, int]]:
    """Returns (matched byte position, score) or None."""
    needle_len = len(needle.encode("utf-8"))
    if len(haystack) < needle_len or needle_len == 0:
        return None
    units = _needle_variants(needle, unicode, case_sensitive)

    if mode is Matching.EXACT:
        if len(haystack) == needle_len and _matches_at(units, haystack, 0):
            return (0, _score_at(units, haystack, 0, needle_len, scoring))
        return None
    if mode is Matching.PREFIX:
        if _matches_at(units, haystack, 0):
            return (0, _score_at(units, haystack, 0, needle_len, scoring))
        return None
    if mode is Matching.SUFFIX:
        pos = len(haystack) - needle_len
        if _matches_at(units, haystack, pos):
            return (pos, _score_at(units, haystack, pos, needle_len, scoring))
        return None
    if mode is Matching.SUBSTRING:
        best: Optional[Tuple[int, int]] = None
        for pos in range(0, len(haystack) - needle_len + 1):
            if _matches_at(units, haystack, pos):
                score = _score_at(units, haystack, pos, needle_len, scoring)
                if best is None or score > best[1]:
                    best = (pos, score)
        return best
    raise ValueError("fuzzy matching does not use the literal path")
