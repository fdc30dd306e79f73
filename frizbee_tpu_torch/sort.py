"""Public sorting and k-way merge utilities (a copy of
``frizbee_tpu/sort.py``).

API parity with the reference's free functions (reference: src/sort.rs,
src/k_merge.rs, re-exported at src/lib.rs:111,121-123). The reference's
2-pass LSB radix sort exists because comparison sorts are slow on CPU for
100k+ elements; here the hot path sorts on device (ops/batch.py), so these
host utilities are stable NumPy sorts with the same contracts:

- ``sort_matches``: stable sort by score descending — combined with the
  stable preservation of index order this yields (score desc, index asc),
  exactly like the reference's radix path.
- ``k_merge_matches_by_*``: merge pre-sorted runs under the four merge
  orders; because (score, index) is a total order (indices unique), a flat
  stable merge reproduces the reference's loser-heap output exactly.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .types import Match


def sort_matches(matches: Sequence[Match]) -> List[Match]:
    """Stable sort by u16 score, descending (reference: src/sort.rs:6-40).

    A stable NumPy argsort over the u16 score key; equal scores keep input
    (index) order, reproducing the reference's radix-sort output exactly
    (the radix trick itself isn't needed — this host path only handles
    small result sets and test corpora; bulk sorting happens on device).
    """
    if len(matches) <= 1:
        return list(matches)
    scores = np.fromiter(
        (m.score for m in matches), dtype=np.int64, count=len(matches)
    )
    order = np.argsort(-scores, kind="stable")
    return [matches[i] for i in order]


def _merge(runs: Sequence[Sequence[Match]], key) -> List[Match]:
    merged = [m for run in runs for m in run]
    merged.sort(key=key)
    return merged


def k_merge_matches_by_score_then_index_asc(
    runs: Sequence[Sequence[Match]],
) -> List[Match]:
    """(score desc, index asc) merge (reference: src/k_merge.rs)."""
    return _merge(runs, lambda m: (-m.score, m.index))


def k_merge_matches_by_score_then_index_desc(
    runs: Sequence[Sequence[Match]],
) -> List[Match]:
    return _merge(runs, lambda m: (-m.score, -m.index))


def k_merge_matches_by_index_asc(
    runs: Sequence[Sequence[Match]],
) -> List[Match]:
    return _merge(runs, lambda m: m.index)


def k_merge_matches_by_index_desc(
    runs: Sequence[Sequence[Match]],
) -> List[Match]:
    return _merge(runs, lambda m: -m.index)
