"""Picker traffic: each query is a fragment a user types, drawn from the
corpus's own rows.

Mix parameters (``portbench/traffic/<mix>.json``, key ``params``):

- ``lengths``: the needle length of each of a batch's queries, in
  characters; every batch has exactly these lengths, so every seed gives
  the same shape groups;
- ``fixed``: queries in every batch, each in place of a drawn query of
  its length;
- ``split``: the characters that cut a row into tokens (path separators,
  spaces);
- ``kinds``: how a fragment is cut from a token of at least its length,
  one drawn uniformly per query: ``prefix``, ``subsequence`` (characters
  in order at random places) or ``substring`` (a contiguous run).

A query's shape label is its length.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np


def tokens_of(row: str, split: str) -> List[str]:
    return [t for t in re.split("[" + re.escape(split) + "]", row) if t]


def fragment(rows: Sequence[str], length: int, split: str,
             kinds: Sequence[str], rng: np.random.Generator) -> str:
    """A fragment of ``length`` characters of a random row's token."""
    while True:
        toks = [t for t in tokens_of(rows[int(rng.integers(len(rows)))],
                                     split) if len(t) >= length]
        if toks:
            break
    tok = toks[int(rng.integers(len(toks)))]
    kind = kinds[int(rng.integers(len(kinds)))]
    if kind == "prefix":
        return tok[:length]
    if kind == "substring":
        at = int(rng.integers(len(tok) - length + 1))
        return tok[at:at + length]
    if kind == "subsequence":
        at = np.sort(rng.choice(len(tok), size=length, replace=False))
        return "".join(tok[i] for i in at)
    raise ValueError(f"unknown fragment kind {kind!r}")


def generate(rows: Sequence[str], params: dict, n_batches: int,
             rng: np.random.Generator):
    """(batches, shape label of each query)."""
    lengths = list(params["lengths"])
    fixed = list(params.get("fixed", []))
    batches, shapes = [], {}
    for _ in range(n_batches):
        slots = list(lengths)
        batch = [None] * len(slots)
        for q in fixed:
            i = next(i for i, L in enumerate(slots)
                     if L == len(q) and batch[i] is None)
            batch[i] = q
        for i, L in enumerate(slots):
            if batch[i] is None:
                batch[i] = fragment(rows, L, params["split"],
                                    params["kinds"], rng)
        order = rng.permutation(len(batch))
        batch = [batch[i] for i in order]
        for q in batch:
            shapes[q] = str(len(q))
        batches.append(batch)
    return batches, shapes
