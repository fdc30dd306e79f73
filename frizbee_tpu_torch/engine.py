"""Per-pattern engine state the batch serving path reads.

Counterpart of the needle side of ``frizbee_tpu/engine.FuzzyEngine`` and
``LiteralEngine``: unit tokenization, case and unicode resolution, the
u16 overflow guards, and the host needle arrays the dispatcher stacks per
batch. The per-row host pipelines (greedy, XL rows, the host literal
matchers) come with later slices.
"""

from __future__ import annotations

import numpy as np

from .config import U16_MAX, Config
from .oracle import make_needle_units
from .ops.fuzzy import SCORING_FIELDS


class _NeedleEngine:
    """Needle units and the cached host arrays both engines share."""

    def __init__(self, needle: str, config: Config):
        self.needle = needle
        self.config = config
        self.case_sensitive = config.casing.respects_case_for(needle)
        self.unicode = config.unicode.respects_unicode_for(needle)
        self.needle_bytes = needle.encode("utf-8")
        self._guard_overflow()
        self.units = make_needle_units(needle, self.unicode, self.case_sensitive)
        self._host_args = None

    def _guard_overflow(self) -> None:
        raise NotImplementedError

    def _host_needle(self):
        """(orig (n,), flip (n,), scoring (9,)) int32 host arrays (cached):
        the batch dispatcher stacks them per group and ships one array."""
        if self._host_args is None:
            self._host_args = (
                np.array(self.units.orig, np.int32),
                np.array(self.units.flip, np.int32),
                np.array(
                    [getattr(self.config.scoring, f)
                     for f in SCORING_FIELDS], np.int32,
                ),
            )
        return self._host_args


class FuzzyEngine(_NeedleEngine):
    """Fuzzy (Smith-Waterman) matching for one needle + resolved config."""

    def _guard_overflow(self) -> None:
        # Overflow guard uses the row count the needle actually uses
        # (reference: src/matcher/algo.rs:300-325)
        rows = len(self.needle) if self.unicode else len(self.needle_bytes)
        scoring = self.config.scoring
        scoring.guard_against_score_overflow(
            rows, scoring.max_per_char_bonus(), scoring.max_one_time_bonus()
        )


class LiteralEngine(_NeedleEngine):
    """Literal matching modes; max_typos is ignored
    (reference: src/literal/mod.rs:1-8)."""

    def _guard_overflow(self) -> None:
        # Literal overflow guard (reference: src/literal/algo.rs:316-325)
        s = self.config.scoring
        max_bonus = min(
            max(s.capitalization_bonus, s.delimiter_bonus)
            + s.matching_case_bonus,
            U16_MAX,
        )
        s.guard_against_score_overflow(len(self.needle_bytes), max_bonus, 0)


def make_engine(needle: str, config: Config):
    if config.matching.is_fuzzy:
        return FuzzyEngine(needle, config)
    return LiteralEngine(needle, config)
