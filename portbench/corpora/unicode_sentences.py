"""Unicode sentence corpus calibrated to saghen/frizbee's Arabic sentence
benchmark (BENCHMARKS.md:84-85: 285,587 sentences, needle "إن").

The statistics of ``frizbee_tpu_torch.datagen.unicode_corpus`` with its
Arabic calibration, drawn in bulk instead of a row at a time (so a seed
gives other sentences than that loop's): row lengths in codepoints from
a normal distribution (median ``median_units``, deviation a quarter of
it, at least 2); codepoints uniform over the script's block, never one of
the needle's; 15% of them turned into ASCII spaces; every
``needle_every``-th row long enough embeds the whole needle in order at
random places (a match); ``partial_rate`` of the other rows get one
needle codepoint at a random place (a partial: it trips presence
filters without matching).
"""

from __future__ import annotations

from typing import List

import numpy as np

SCRIPTS = {"arabic": (0x0621, 0x064A)}
SPACE_SHARE = 0.15


def generate(num_samples: int = 285_587, median_units: int = 20,
             needle_every: int = 13, partial_rate: float = 0.645,
             needle: str = "إن", script: str = "arabic",
             seed: int = 42) -> List[str]:
    rng = np.random.default_rng(seed)
    n = num_samples
    lo, hi = SCRIPTS[script]
    nd = np.array([ord(c) for c in needle], np.uint32)
    lengths = np.maximum(
        np.abs(np.round(rng.normal(median_units, median_units // 4, n))), 2
    ).astype(np.int64)
    row0 = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=row0[1:])
    total = int(row0[-1])
    cps = rng.integers(lo, hi + 1, size=total, dtype=np.uint32)
    bad = np.isin(cps, nd)
    while bad.any():
        cps[bad] = rng.integers(lo, hi + 1, size=int(bad.sum()),
                                dtype=np.uint32)
        bad = np.isin(cps, nd)
    cps[rng.random(total) < SPACE_SHARE] = 0x20
    m = len(nd)
    full = (np.arange(n) % needle_every == 0) & (lengths >= m)
    partial = ~full & (rng.random(n) < partial_rate)
    if m:
        # the whole needle at m distinct places of each full row, in
        # order: the m smallest of a random key over the row's units
        rows = np.nonzero(full)[0]
        unit_row = np.repeat(rows, lengths[rows])
        first = np.repeat(np.cumsum(lengths[rows]) - lengths[rows],
                          lengths[rows])
        unit_pos = np.arange(len(unit_row)) - first
        key = rng.random(len(unit_row))
        order = np.lexsort((key, unit_row))
        chosen = order[unit_pos < m]  # sorted by row: unit_pos is the rank
        # back in position order inside each row, then the needle's units
        chosen = chosen[np.lexsort((unit_pos[chosen], unit_row[chosen]))]
        cps[row0[unit_row[chosen]] + unit_pos[chosen]] = np.tile(
            nd, len(rows))
        prow = np.nonzero(partial)[0]
        at = (rng.random(len(prow)) * lengths[prow]).astype(np.int64)
        cps[row0[prow] + at] = nd[rng.integers(0, m, len(prow))]
    text = cps.astype("<u4").tobytes().decode("utf-32-le")
    return [text[a:b] for a, b in zip(row0[:-1].tolist(), row0[1:].tolist())]
