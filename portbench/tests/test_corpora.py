"""The corpus generators hold the published statistics at full scale, and
the Chromium one is the port's generator draw for draw."""

import numpy as np
import pytest

from frizbee_tpu_torch import datagen
from portbench.corpora import chromium_like, unicode_sentences


def subsequence(needle, row):
    at = -1
    for c in needle:
        at = row.find(c, at + 1)
        if at < 0:
            return False
    return True


@pytest.mark.parametrize("n,seed", [(1, 0), (5, 3), (20000, 7)])
def test_chromium_same_as_port_generator(n, seed):
    assert chromium_like.generate(n, seed) == datagen.chromium_like_corpus(
        n, seed=seed)


def test_chromium_published_statistics():
    """1,406,941 rows, median 67 bytes (the generator gives 65), "linux"
    matching about 8% (BENCHMARKS.md:50-58)."""
    rows = chromium_like.generate(seed=2**33 + 17)
    assert len(rows) == 1_406_941
    lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
    assert 63 <= np.median(lens) <= 70
    share = sum(subsequence("linux", r) for r in rows) / len(rows)
    assert 0.075 <= share <= 0.085


def test_arabic_published_statistics():
    """Published: 285,587 rows, median 37 bytes, the needle matching
    7.93% and partial in 59.5% (BENCHMARKS.md:84-85). The generator: a
    median of 20 codepoints (37 bytes), the needle in every 13th row
    (7.7%), one needle codepoint in 64.5% of the others (59.5% of all
    rows)."""
    rows = unicode_sentences.generate(seed=2**33 + 18)
    assert len(rows) == 285_587
    assert np.median([len(r) for r in rows]) == 20
    assert np.median([len(r.encode()) for r in rows]) == 37
    full = np.array([subsequence("إن", r) for r in rows])
    assert abs(full.mean() - 1 / 13) < 0.002
    partial = np.array([("إ" in r or "ن" in r) for r in rows]) & ~full
    assert abs(partial.sum() / (~full).sum() - 0.645) < 0.005
    assert abs(partial.mean() - 0.595) < 0.005


def test_arabic_repeats_for_a_seed():
    assert unicode_sentences.generate(500, seed=9) == (
        unicode_sentences.generate(500, seed=9))
    assert unicode_sentences.generate(500, seed=9) != (
        unicode_sentences.generate(500, seed=10))
