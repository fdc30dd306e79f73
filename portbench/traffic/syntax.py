"""fzf-style query traffic: each query is a few atoms of the query syntax
(fuzzy, ``'substring``, ``^prefix``, ``suffix$``, negations).

Mix parameters (``portbench/traffic/<mix>.json``, key ``params``):

- ``templates``: a list of ``{"count": c, "atoms": [...]}``; each batch
  holds ``c`` queries of each template, so every seed gives the same
  shape groups. An atom is ``{"kind": k, "len": L}`` for the kinds cut
  from the corpus's own tokens (``fuzzy``: a prefix or in-order
  subsequence; ``substring`` and ``not_substring``: a contiguous run) or
  ``{"kind": k, "choices": [...]}`` for ``prefix``, ``suffix`` and
  ``not_prefix`` (one choice drawn per query; a template's choices share
  one length);
- ``split``: the characters that cut a row into tokens.

A query's shape label is its template's index.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from portbench.traffic.fragments import fragment

_CUT = {"fuzzy": ("", ("prefix", "subsequence")),
        "substring": ("'", ("substring",)),
        "not_substring": ("!", ("substring",))}
_CHOSEN = {"prefix": ("^", ""), "suffix": ("", "$"),
           "not_prefix": ("!^", "")}


def atom(spec: dict, rows: Sequence[str], split: str,
         rng: np.random.Generator) -> str:
    kind = spec["kind"]
    if kind in _CUT:
        mark, kinds = _CUT[kind]
        return mark + fragment(rows, spec["len"], split, kinds, rng)
    if kind in _CHOSEN:
        head, tail = _CHOSEN[kind]
        choices = spec["choices"]
        return head + choices[int(rng.integers(len(choices)))] + tail
    raise ValueError(f"unknown atom kind {kind!r}")


def generate(rows: Sequence[str], params: dict, n_batches: int,
             rng: np.random.Generator):
    """(batches, shape label of each query)."""
    batches, shapes = [], {}
    for _ in range(n_batches):
        batch = []
        for t, tpl in enumerate(params["templates"]):
            for _ in range(tpl["count"]):
                q = " ".join(atom(a, rows, params["split"], rng)
                             for a in tpl["atoms"])
                batch.append(q)
                shapes[q] = str(t)
        order = rng.permutation(len(batch))
        batches.append([batch[i] for i in order])
    return batches, shapes
