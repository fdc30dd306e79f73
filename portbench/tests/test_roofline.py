"""The roofline's work, counted by hand on a tiny corpus."""

import pytest

from portbench import roofline
from portbench.corpora import chromium_like, unicode_sentences
from portbench.harness import HERE, load_json, load_module, rng_for
from portbench.reference import Corpus

ROWS = ["abc", "xbc", "ab"]


def test_fuzzy_query_work():
    """"ab" at T=0: rows 0 and 2 hold both units (alive); the prefilter
    walks their 3 + 2 units at 2 x 6 + 8 = 20 operations a column (a
    needle under 4 units); both pass, each window is units 0-1, so the
    DP runs 2 + 2 units x 2 cells x 10 operations."""
    work = roofline.query_work(Corpus(ROWS, "cpu"), "ab", {"max_typos": 0})
    assert work.ops == 5 * 20 + 4 * 2 * 10
    assert work.alive[False].tolist() == [True, False, True]
    assert work.past_ops == 0 and work.greedy == {}


def test_literal_query_work():
    """'bc: rows 0 and 1 hold "b" and "c"; a substring walks every
    column, 3 + 3, at 7 x 2 + 8 operations."""
    work = roofline.query_work(Corpus(ROWS, "cpu"), "'bc", {})
    assert work.ops == 6 * (7 * 2 + 8)
    assert work.alive[False].tolist() == [True, True, False]


def test_no_budget_scores_every_row():
    """"b" with no budget: no prefilter, the DP over all 8 units."""
    work = roofline.query_work(Corpus(ROWS, "cpu"), "b",
                               {"max_typos": None})
    assert work.ops == 8 * 1 * 10
    assert work.alive[False].all()


def test_batch_bound():
    """Both queries in one batch at k=4: 312 operations; every row read
    once (8 bytes of units + 8 bytes a row), a 5-entry answer of 8 bytes
    a query written; bytes bound it."""
    (bound_s, what, in_b, out_b, ops, past_in, past_ops), = (
        roofline.batch_bounds(Corpus(ROWS, "cpu"), [["ab", "'bc"]],
                              {"max_typos": 0}, 4))
    assert (in_b, out_b, ops) == (8 + 3 * 8, 2 * 5 * 8, 312)
    assert (past_in, past_ops) == (0, 0)
    assert what == "bytes"
    assert bound_s == pytest.approx((32 + 80) / 3.35e12)


def test_peaks_are_chip_smokes():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.ISSUE_OPS_PER_S == 128 * 132 * 1.98e9
    assert roofline._bound(3.35e12, 0, 0) == (1e3, "bytes")


# rows past the DP's cap: "a", 1,100 x "x", "b" is an XL row whose "ab"
# window (1,102 bytes) takes the greedy scan; 1,100 x "x" then "ab" is an
# XL row whose window (the byte before "a" on: 3 bytes) takes the DP
LONG = ["ab", "a" + "x" * 1100 + "b", "x" * 1100 + "ab"]


def test_greedy_window_and_xl_rows():
    """"ab" at T=0: every row alive; the prefilter walks 2 + 1,102 +
    1,102 units at 20 operations a column, 2,204 of them in XL rows; the
    DP runs row 0's 2 units and row 2's 3 at 2 cells x 10 operations; row
    1's greedy scan reads all 1,102 bytes (its last hit is the window's
    last byte) at 17 operations a byte. Past the cap: the XL rows'
    prefilter, row 2's DP and the scan."""
    work = roofline.query_work(Corpus(LONG, "cpu"), "ab", {"max_typos": 0})
    scan = 1102 * roofline.GREEDY_OPS_PER_BYTE
    assert roofline.GREEDY_OPS_PER_BYTE == 17
    assert work.ops == 2206 * 20 + (2 + 3) * 2 * 10 + scan
    assert work.past_ops == 2204 * 20 + 3 * 2 * 10 + scan
    rows, nbytes = work.greedy[False]
    assert rows.tolist() == [1] and nbytes.tolist() == [1102]


def test_greedy_window_batch_bound():
    """Bytes of "ab" over ``LONG`` at k=4: 2,206 byte units and 8 bytes a
    row, the greedy window's bytes among them; past the cap the two XL
    rows, 2,204 units and 16 bytes."""
    (_s, _w, in_b, out_b, ops, past_in, past_ops), = roofline.batch_bounds(
        Corpus(LONG, "cpu"), [["ab"]], {"max_typos": 0}, 4)
    assert (in_b, out_b, past_in) == (2206 + 24, 40, 2204 + 16)
    assert past_ops == ops - 2 * 20 - 2 * 2 * 10


def test_greedy_scan_reads_to_the_failing_byte():
    """"abc" at T=1 over row 1: the window is the whole row (from the
    first "a" or "b" to the last "b" or "c"); the scan places "a" at 0,
    then "b" may sit no later than 1,102 - 3 + 1 = 1,100, so it reads
    bytes 1-1,100 and fails: 1,101 bytes read, score 0. The prefilter
    (T=1, 3 units) costs 3 x (5 + 3 x 2) = 33 a column."""
    work = roofline.query_work(Corpus(LONG[1:2], "cpu"), "abc",
                               {"max_typos": 1})
    assert work.ops == 1102 * 33 + 1101 * roofline.GREEDY_OPS_PER_BYTE


def test_greedy_window_in_codepoint_row():
    """"إن" over a row of 602 codepoints and 1,204 bytes: no XL row, but
    its window is the whole row, over the cap; the scan reads every byte
    (the last needle byte is the row's last). Its bytes are read beside
    the row's codepoints (4 bytes each, and 8 bytes the row), and all of
    them are past the cap."""
    row = "إ" + "ب" * 600 + "ن"
    corpus = Corpus([row], "cpu")
    scan = 1204 * roofline.GREEDY_OPS_PER_BYTE
    work = roofline.query_work(corpus, "إن", {"max_typos": 0})
    assert work.ops == 602 * 20 + scan and work.past_ops == scan
    (_s, _w, in_b, _o, _ops, past_in, past_ops), = roofline.batch_bounds(
        corpus, [["إن", "إن"]], {"max_typos": 0}, 4)
    assert (in_b, past_in, past_ops) == (602 * 4 + 8 + 1204, 1204, 2 * scan)


# batch_bounds of two generated batches of each cell's mix over small
# corpora, as the roofline gave them before it counted greedy windows
# (rows within the cap: these must not move)
PINNED = {
    "paths_fuzzy": [
        (2.5488327881083563e-06, "operations", 146160.0, 524544.0,
         85268856.0),
        (2.7594605501033057e-06, "operations", 146160.0, 524544.0,
         92315214.0)],
    "paths_allscores": [
        (8.092669115396389e-06, "operations", 146160.0, 524544.0,
         270732800.0),
        (8.092669115396389e-06, "operations", 146160.0, 524544.0,
         270732800.0)],
    "sentences_fuzzy": [
        (1.8950805970149252e-07, "bytes", 110308.0, 524544.0, 1910334.0),
        (1.8938388059701493e-07, "bytes", 109892.0, 524544.0, 1896800.0)],
}


@pytest.mark.parametrize("mix", sorted(PINNED))
def test_cell_mixes_bounds_pinned(mix):
    if mix == "sentences_fuzzy":
        rows = unicode_sentences.generate(1500, seed=6)
    else:
        rows = chromium_like.generate(2000, seed=5)
    m = load_json(HERE, "traffic", f"{mix}.json")
    batches, _ = load_module("traffic", m["generator"]).generate(
        rows, m["params"], 2, rng_for(7, 1))
    got = roofline.batch_bounds(Corpus(rows, "cpu"), batches, m["config"],
                                m["k"])
    assert [tuple(b[:5]) for b in got] == PINNED[mix]
    assert all(b.past_in_bytes == 0 and b.past_ops == 0 for b in got)
