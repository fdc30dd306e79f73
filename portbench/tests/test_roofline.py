"""The roofline's work, counted by hand on a tiny corpus."""

import pytest

from portbench import roofline
from portbench.reference import Corpus

ROWS = ["abc", "xbc", "ab"]


def test_fuzzy_query_work():
    """"ab" at T=0: rows 0 and 2 hold both units (alive); the prefilter
    walks their 3 + 2 units at 2 x 6 + 8 = 20 operations a column (a
    needle under 4 units); both pass, each window is units 0-1, so the
    DP runs 2 + 2 units x 2 cells x 10 operations."""
    ops, alive = roofline.query_work(Corpus(ROWS, "cpu"), "ab",
                                     {"max_typos": 0})
    assert ops == 5 * 20 + 4 * 2 * 10
    assert alive[False].tolist() == [True, False, True]


def test_literal_query_work():
    """'bc: rows 0 and 1 hold "b" and "c"; a substring walks every
    column, 3 + 3, at 7 x 2 + 8 operations."""
    ops, alive = roofline.query_work(Corpus(ROWS, "cpu"), "'bc", {})
    assert ops == 6 * (7 * 2 + 8)
    assert alive[False].tolist() == [True, True, False]


def test_no_budget_scores_every_row():
    """"b" with no budget: no prefilter, the DP over all 8 units."""
    ops, alive = roofline.query_work(Corpus(ROWS, "cpu"), "b",
                                     {"max_typos": None})
    assert ops == 8 * 1 * 10
    assert alive[False].all()


def test_batch_bound():
    """Both queries in one batch at k=4: 312 operations; every row read
    once (8 bytes of units + 8 bytes a row), a 5-entry answer of 8 bytes
    a query written; bytes bound it."""
    (bound_s, what, in_b, out_b, ops), = roofline.batch_bounds(
        Corpus(ROWS, "cpu"), [["ab", "'bc"]], {"max_typos": 0}, 4)
    assert (in_b, out_b, ops) == (8 + 3 * 8, 2 * 5 * 8, 312)
    assert what == "bytes"
    assert bound_s == pytest.approx((32 + 80) / 3.35e12)


def test_peaks_are_chip_smokes():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.ISSUE_OPS_PER_S == 128 * 132 * 1.98e9
    assert roofline._bound(3.35e12, 0, 0) == (1e3, "bytes")
