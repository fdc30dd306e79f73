"""A query's top-k answer over a whole corpus: every atom over every row,
combined, counted and ordered (saghen/frizbee: src/matcher/multi.rs,
src/sort.rs).

A row matches a query when every non-negated atom matches it and no
negated one does; its score is the sum of the non-negated atoms' scores
(saturating at 0xFFFF), ``exact`` their OR and end_col their maximum.
The answer is ``(count, index, score, exact, end_col)``: how many rows
match, and the first ``k`` of them by score descending, ties by
ascending row index.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .fuzzy import U16_MAX, fuzzy_block
from .literal import literal_block
from .query import FUZZY, parse_query
from .units import Units

DEFAULT_SCORING = {
    "match_score": 12, "mismatch_penalty": 6, "gap_open_penalty": 5,
    "gap_extend_penalty": 1, "prefix_bonus": 12, "capitalization_bonus": 4,
    "matching_case_bonus": 4, "exact_match_bonus": 8, "delimiter_bonus": 4,
}

# cells of one padded block: a block's working set stays a few GB
BLOCK_CELLS = 1 << 26


class Corpus:
    """The strings, and their units in each mode once a query needs it."""

    def __init__(self, strings: Sequence[str], device):
        self.strings = strings
        self.device = torch.device(device)
        self._units: Dict[bool, Units] = {}

    def __len__(self):
        return len(self.strings)

    def units(self, unicode: bool) -> Units:
        if unicode not in self._units:
            self._units[unicode] = Units(self.strings, unicode, self.device)
        return self._units[unicode]


def atom_rows(corpus: Corpus, atom, max_typos: Optional[int], scoring):
    """(matched, score, exact, end_col) of every row for one atom, in
    corpus order."""
    n = len(corpus)
    dev = corpus.device
    out = (torch.zeros(n, dtype=torch.bool, device=dev),
           torch.zeros(n, dtype=torch.int32, device=dev),
           torch.zeros(n, dtype=torch.bool, device=dev),
           torch.zeros(n, dtype=torch.int32, device=dev))
    # the literal path reads bytes in either mode; the fuzzy path units
    units = corpus.units(atom.unicode if atom.mode == FUZZY else False)
    for blk in units.blocks(BLOCK_CELLS):
        if atom.mode == FUZZY:
            res = fuzzy_block(blk, atom, max_typos, scoring,
                              units.byte_windows)
        else:
            res = literal_block(units.byte_block(blk.rows), blk.n_bytes,
                                atom, scoring)
        for o, r in zip(out, res):
            o[blk.rows] = r
    return out


def combine(per_atom, negated, n, device):
    """The multi-atom combine over per-atom row results."""
    matched = torch.ones(n, dtype=torch.bool, device=device)
    score = torch.zeros(n, dtype=torch.int32, device=device)
    exact = torch.zeros(n, dtype=torch.bool, device=device)
    end_col = torch.zeros(n, dtype=torch.int32, device=device)
    for (m, s, e, ec), neg in zip(per_atom, negated):
        if neg:
            matched &= ~m
        else:
            matched &= m
            score = (score + torch.where(m, s, 0)).clamp(max=U16_MAX)
            exact |= e & m
            end_col = torch.maximum(end_col, torch.where(m, ec, 0))
    return matched, score, exact, end_col


def top_k(matched, score, exact, end_col, k: int, ties: str = "asc"):
    """(count, index, score, exact, end_col) as NumPy: the first ``k``
    matched rows by score descending, ties by ascending index (``ties=
    "desc"`` reverses the tie order: the benchmark's control)."""
    idx = torch.nonzero(matched).flatten()
    if ties == "desc":
        idx = idx.flip(0)
    s = score[idx]
    order = torch.sort(-s.long(), stable=True).indices[:k]
    top = idx[order]
    return (int(len(idx)), top.cpu().numpy().astype(np.int64),
            score[top].cpu().numpy().astype(np.int64),
            exact[top].cpu().numpy(),
            end_col[top].cpu().numpy().astype(np.int64))


def answer(corpus: Corpus, query: str, config: dict, k: int,
           ties: str = "asc"):
    """The reference's top-k answer of one query; ``config`` holds the
    Config fields the traffic sets (``max_typos``, ``scoring``)."""
    max_typos = config.get("max_typos", 0)
    scoring = {**DEFAULT_SCORING, **config.get("scoring", {})}
    atoms = parse_query(query)
    if not atoms:
        raise ValueError(f"query {query!r} has no atoms")
    per_atom = [atom_rows(corpus, a, max_typos, scoring) for a in atoms]
    res = combine(per_atom, [a.negated for a in atoms], len(corpus),
                  corpus.device)
    return top_k(*res, k, ties)
