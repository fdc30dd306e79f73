"""Configuration and scoring types.

TPU-native re-design of the reference's public config surface
(reference: src/lib.rs:236-538, src/const.rs:1-10). Semantics are kept
identical — including the u16 saturating-arithmetic overflow guards — but the
types are plain Python dataclasses/enums.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional

U16_MAX = 0xFFFF

# Default scoring constants (reference: src/const.rs:1-10)
MATCH_SCORE = 12
MISMATCH_PENALTY = 6
GAP_OPEN_PENALTY = 5
GAP_EXTEND_PENALTY = 1
PREFIX_BONUS = 12
DELIMITER_BONUS = 4
CAPITALIZATION_BONUS = 4
MATCHING_CASE_BONUS = 4
EXACT_MATCH_BONUS = 8

# Haystacks longer than this (in bytes, after window trimming) fall back to the
# linear-time greedy matcher (reference: src/smith_waterman/algo/mod.rs:18)
MAX_HAYSTACK_LEN = 1024


def sat_add_u16(a: int, b: int) -> int:
    return min(a + b, U16_MAX)


def sat_sub_u16(a: int, b: int) -> int:
    return max(a - b, 0)


def sat_mul_u16(a: int, b: int) -> int:
    return min(a * b, U16_MAX)


class CaseMatching(enum.Enum):
    """How case sensitivity is handled (reference: src/lib.rs:356-377)."""

    IGNORE = "ignore"
    SMART = "smart"
    RESPECT = "respect"

    def respects_case_for(self, needle: str) -> bool:
        if self is CaseMatching.IGNORE:
            return False
        if self is CaseMatching.SMART:
            return any(c.isupper() for c in needle)
        return True


class UnicodeMatching(enum.Enum):
    """How unicode is handled (reference: src/lib.rs:379-401)."""

    IGNORE = "ignore"
    SMART = "smart"
    ALWAYS = "always"

    def respects_unicode_for(self, needle: str) -> bool:
        if self is UnicodeMatching.IGNORE:
            return False
        if self is UnicodeMatching.SMART:
            return not needle.isascii()
        return True


class Matching(enum.Enum):
    """Selects the matching algorithm (reference: src/lib.rs:403-434)."""

    FUZZY = "fuzzy"
    EXACT = "exact"
    PREFIX = "prefix"
    SUFFIX = "suffix"
    SUBSTRING = "substring"

    @property
    def is_fuzzy(self) -> bool:
        return self is Matching.FUZZY


class SortStrategy(enum.Enum):
    """Result ordering (reference: src/lib.rs:311-354)."""

    SCORE_THEN_INDEX_ASC = "score_then_index_asc"
    SCORE_THEN_INDEX_DESC = "score_then_index_desc"
    INDEX_ASC = "index_asc"
    INDEX_DESC = "index_desc"

    def reverse(self) -> "SortStrategy":
        return {
            SortStrategy.SCORE_THEN_INDEX_ASC: SortStrategy.SCORE_THEN_INDEX_DESC,
            SortStrategy.SCORE_THEN_INDEX_DESC: SortStrategy.SCORE_THEN_INDEX_ASC,
            SortStrategy.INDEX_ASC: SortStrategy.INDEX_DESC,
            SortStrategy.INDEX_DESC: SortStrategy.INDEX_ASC,
        }[self]

    @property
    def is_reversed(self) -> bool:
        return self in (SortStrategy.INDEX_DESC, SortStrategy.SCORE_THEN_INDEX_DESC)

    @property
    def is_by_score(self) -> bool:
        return self in (
            SortStrategy.SCORE_THEN_INDEX_ASC,
            SortStrategy.SCORE_THEN_INDEX_DESC,
        )


@dataclass(frozen=True)
class Scoring:
    """Smith-Waterman scoring knobs (reference: src/lib.rs:436-538).

    All values behave as u16 with saturating arithmetic, exactly like the
    reference. The overflow guards mirror the reference's panics as
    ``ValueError``.
    """

    match_score: int = MATCH_SCORE
    mismatch_penalty: int = MISMATCH_PENALTY
    gap_open_penalty: int = GAP_OPEN_PENALTY
    gap_extend_penalty: int = GAP_EXTEND_PENALTY
    prefix_bonus: int = PREFIX_BONUS
    capitalization_bonus: int = CAPITALIZATION_BONUS
    matching_case_bonus: int = MATCHING_CASE_BONUS
    exact_match_bonus: int = EXACT_MATCH_BONUS
    delimiter_bonus: int = DELIMITER_BONUS

    def max_needle_len(self) -> int:
        """Max needle length matchable without u16 overflow
        (reference: src/lib.rs:487-491)."""
        per_char = self.max_per_char_bonus()
        return (U16_MAX - min(self.max_one_time_bonus(), U16_MAX)) // per_char

    def max_per_char_bonus(self) -> int:
        """Max per-char bonus beyond the match score
        (reference: src/lib.rs:494-500)."""
        bonus = max(self.delimiter_bonus, self.capitalization_bonus)
        amortized = max(-(-bonus // 2), sat_sub_u16(bonus, self.gap_open_penalty))
        return sat_add_u16(amortized, self.matching_case_bonus)

    def max_one_time_bonus(self) -> int:
        """Max one-time bonus aside from prefix/exact
        (reference: src/lib.rs:503-508)."""
        bonus = max(self.delimiter_bonus, self.capitalization_bonus)
        amortized = max(-(-bonus // 2), sat_sub_u16(bonus, self.gap_open_penalty))
        return bonus - amortized

    def guard_against_score_overflow(
        self, needle_len: int, max_bonus_per_char: int, max_one_time_bonus: int
    ) -> None:
        """Raises if a needle of ``needle_len`` units could overflow the u16
        score (reference: src/lib.rs:511-537)."""
        max_per_char = sat_add_u16(self.match_score, max_bonus_per_char)
        if max_per_char == 0:
            return
        headroom = U16_MAX
        headroom = sat_sub_u16(headroom, self.prefix_bonus)
        headroom = sat_sub_u16(headroom, self.exact_match_bonus)
        headroom = sat_sub_u16(headroom, self.mismatch_penalty)
        headroom = sat_sub_u16(headroom, max_one_time_bonus)
        max_needle_len = headroom // max_per_char
        if needle_len > max_needle_len:
            raise ValueError(
                "needle too long and could overflow the u16 score: "
                f"{needle_len} > {max_needle_len}"
            )
        max_gap_penalty = 32 * self.gap_extend_penalty + self.gap_open_penalty
        if max_gap_penalty > U16_MAX:
            raise ValueError(
                "gap penalties too large and could overflow the u16 score: "
                f"{max_gap_penalty} > {U16_MAX}"
            )


def score_fits_in_u8(needle_len: int, scoring: Scoring) -> bool:
    """True when every matrix cell fits a u8; the reference uses this to pick
    double-width SIMD backends (reference: src/smith_waterman/mod.rs:92-116).
    The port's analogous dispatch predicate is this package's
    ``ops.kernels.score_fits_int16`` (int16 is the narrow lane width of the
    DP kernels' packed s16x2 instantiations); this u8 variant is kept for
    API parity and host-side introspection."""
    max_constant = max(
        scoring.match_score + scoring.mismatch_penalty,
        scoring.gap_open_penalty,
        scoring.gap_extend_penalty,
        scoring.matching_case_bonus,
        scoring.capitalization_bonus,
        scoring.delimiter_bonus,
        scoring.prefix_bonus,
    )
    if max_constant > 0xFF:
        return False
    if 64 * scoring.gap_extend_penalty + scoring.gap_open_penalty > 0xFF:
        return False
    max_per_char = scoring.match_score + scoring.max_per_char_bonus()
    max_matrix_score = (
        max_per_char * needle_len
        + scoring.max_one_time_bonus()
        + scoring.prefix_bonus
    )
    return max_matrix_score + scoring.mismatch_penalty <= 0xFF


@dataclass(frozen=True)
class Config:
    """Matcher-wide configuration (reference: src/lib.rs:236-309)."""

    max_typos: Optional[int] = 0
    casing: CaseMatching = CaseMatching.SMART
    unicode: UnicodeMatching = UnicodeMatching.SMART
    matching: Matching = Matching.FUZZY
    sort: SortStrategy = SortStrategy.SCORE_THEN_INDEX_ASC
    scoring: Scoring = field(default_factory=Scoring)

    def with_(self, **kwargs) -> "Config":
        return replace(self, **kwargs)

    # JSON round-tripping (the analog of the reference's optional serde
    # derives, src/lib.rs:107-108)
    def to_dict(self) -> dict:
        import dataclasses

        d = dataclasses.asdict(self)
        for k in ("casing", "unicode", "matching", "sort"):
            d[k] = d[k].value
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d)
        if "casing" in d:
            d["casing"] = CaseMatching(d["casing"])
        if "unicode" in d:
            d["unicode"] = UnicodeMatching(d["unicode"])
        if "matching" in d:
            d["matching"] = Matching(d["matching"])
        if "sort" in d:
            d["sort"] = SortStrategy(d["sort"])
        if isinstance(d.get("scoring"), dict):
            d["scoring"] = Scoring(**d["scoring"])
        return cls(**d)
