"""Per-pattern engine state the batch serving path reads.

Counterpart of ``frizbee_tpu/engine.FuzzyEngine``'s needle side: unit
tokenization, case and unicode resolution, the u16 overflow guard, and
the host needle arrays the dispatcher stacks per batch. The per-row host
pipelines (greedy, XL rows, literal engines) come with later slices.
"""

from __future__ import annotations

import numpy as np

from .config import Config
from .oracle import make_needle_units
from .ops.fuzzy import SCORING_FIELDS


class FuzzyEngine:
    """Fuzzy (Smith-Waterman) matching for one needle + resolved config."""

    def __init__(self, needle: str, config: Config):
        self.needle = needle
        self.config = config
        self.case_sensitive = config.casing.respects_case_for(needle)
        self.unicode = config.unicode.respects_unicode_for(needle)
        self.needle_bytes = needle.encode("utf-8")

        # Overflow guard uses the row count the needle actually uses
        # (reference: src/matcher/algo.rs:300-325)
        rows = len(needle) if self.unicode else len(self.needle_bytes)
        scoring = config.scoring
        scoring.guard_against_score_overflow(
            rows, scoring.max_per_char_bonus(), scoring.max_one_time_bonus()
        )
        self.units = make_needle_units(needle, self.unicode, self.case_sensitive)
        self._host_args = None

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


def make_engine(needle: str, config: Config) -> FuzzyEngine:
    if not config.matching.is_fuzzy:
        raise NotImplementedError(
            f"{config.matching.value} matching comes with the literal "
            "serving slice"
        )
    return FuzzyEngine(needle, config)
