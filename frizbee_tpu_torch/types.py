"""Result types: ``Match``, the record the engines' ``match_one`` returns.

Copy of the pure-Python ``Match`` of ``frizbee_tpu/types.py`` (its
fields); ``MatchList``, ``MatchIndices`` and the rest of the record's
API come with the single-query Matcher slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(slots=True)
class Match:
    """One matched haystack (reference: src/lib.rs:141-152)."""

    score: int = 0
    index: int = 0
    exact: bool = False
    # 0-based haystack byte offset where the best alignment ends
    # (reference feature `match_end_col`, src/lib.rs:149-152). Always populated.
    end_col: int = 0
