"""The plain reference against the port's host oracle
(``frizbee_tpu_torch.Matcher(use_device=False)``) on small corpora, for
the query shapes of every traffic generator: fuzzy at T=0, T>0 and
``max_typos=None``, literal modes, negated and multi-atom queries, byte
and codepoint rows; and on rows past the DP's 1,024-byte cap, where the
greedy matcher scores the window, with the check's control and faults
on them."""

import numpy as np
import pytest

from frizbee_tpu_torch import Config, Matcher, datagen
from portbench import check
from portbench.corpora import chromium_like, unicode_sentences
from portbench.harness import HERE, load_json, load_module, rng_for
from portbench.reference import Corpus, answer

PATHS = chromium_like.generate(1200, seed=5) + [
    "linux", "Linux/x", "src/linux_linux.cc", "a", "", "x/linuxlinux",
    "Browser_Window.cc", "third_party/blink/BUILD.gn"]
SENTENCES = unicode_sentences.generate(800, seed=6) + [
    "إن", "a إن b", "إنإن", "Ünïcödé إن", "äbc Äbc", ""]


def oracle(hay, query, cfg):
    idx, score, exact, end_col = Matcher.from_query(
        query, Config(**cfg), use_device=False).match_arrays(hay)
    return len(idx), idx, score, exact, end_col


def assert_same(hay, query, cfg, k=2048):
    want = oracle(hay, query, cfg)
    got = answer(Corpus(hay, "cpu"), query, cfg, k)
    assert got[0] == want[0], (query, cfg, "count")
    for name, g, w in zip(("index", "score", "exact", "end_col"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.int64), np.asarray(w[:k]).astype(
                np.int64), err_msg=f"{query!r} {cfg} {name}")


@pytest.mark.parametrize("query,cfg", [
    ("linux", {}), ("src", {}), ("brw", {}), ("ux", {}), ("Linux", {}),
    ("browsr", {"max_typos": 1}), ("brwsx", {"max_typos": 2}),
    ("ab", {"max_typos": 3}),
    ("linux", {"max_typos": None}), ("LX", {"max_typos": None}),
    ("^src/", {}), ("'net", {}), (".cc$", {}), ("^linux$", {}),
    ("browser .cc$ !test", {}), ("^third_party !^third_party/blink", {}),
    ("!^src linux", {}), ("'_mod tab", {}), ("views vw", {}),
])
def test_paths_hand_cases(query, cfg):
    assert_same(PATHS, query, cfg)


@pytest.mark.parametrize("query,cfg", [
    ("إن", {}), ("لا", {}), ("إنم", {}), ("إن", {"max_typos": None}),
    ("إنلا", {"max_typos": 1}), ("Äbc", {}), ("äbc", {}),
    ("إن 'ما", {}), ("إن !ما", {}), ("^إن", {}), ("ن$", {}),
])
def test_sentences_hand_cases(query, cfg):
    assert_same(SENTENCES, query, cfg)


@pytest.mark.parametrize("mix,rows", [
    ("paths_fuzzy", PATHS), ("paths_allscores", PATHS),
    ("paths_syntax", PATHS), ("sentences_fuzzy", SENTENCES),
])
def test_generated_queries(mix, rows):
    """Twelve distinct queries of one generated batch of each mix, with the
    mix's own Config fields and a small k (so the order at the cut
    counts)."""
    m = load_json(HERE, "traffic", f"{mix}.json")
    gen = load_module("traffic", m["generator"])
    batches, _ = gen.generate(rows, m["params"], 1, rng_for(7, 1))
    for q in sorted(set(batches[0]))[:12]:
        assert_same(rows, q, m["config"], k=64)


def test_ties_reversed_differs():
    """The control's tie order is a different answer where scores tie."""
    ref = Corpus(PATHS, "cpu")
    a = answer(ref, "src", {}, 64)
    b = answer(ref, "src", {}, 64, ties="desc")
    assert a[0] == b[0] and not np.array_equal(a[1], b[1])


# Rows past the DP's 1,024-byte cap: saghen/frizbee's greedy matcher
# scores every window over it, on bytes in either unit mode.


def _long_lines(n, seed):
    """``path:line:col:text`` lines as a code search prints them, 1-16 KB
    (minified or generated sources give such lines)."""
    rng = np.random.default_rng(seed)
    words = chromium_like.generate(400, seed=seed)
    out = []
    for _ in range(n):
        target = int(rng.integers(1025, 16385))
        parts = [words[int(rng.integers(len(words)))],
                 str(int(rng.integers(1, 5000))),
                 str(int(rng.integers(1, 80)))]
        text = []
        while sum(map(len, text)) + len(text) < target:
            w = words[int(rng.integers(len(words)))]
            text.append(w.split("/")[int(rng.integers(w.count("/") + 1))])
        out.append(":".join(parts + [" ".join(text)])[:target])
    return out


def _window_rows():
    """Rows whose T=0 window for "ab" is 1,024 or 1,025 bytes (from the
    row's start, and from a later byte), and hand rows for the bonuses
    and the scan's corners."""
    fill = "xyz01"
    rows = []
    for size in (1024, 1025):
        body = (fill * 300)[:size - 3]
        rows.append("a" + body[:1] + "a" + body[1:] + "b")  # starts the row
        rows.append("qq" + "x" + "a" + body[:size - 3] + "b" + "q")
    rows += [
        "--__//" + "a" + fill * 250 + "_b" + fill * 10,      # delimiters first
        "_" + fill * 250 + "a/b",                             # gate opened
        "xA" + fill * 250 + "xB" + "/ab",                     # capitalization
        "aB" + fill * 300 + "Ab",                             # case as written
        "ab" + fill * 300,                                    # prefix bonus
        "a" * 1100 + "b" * 3,                                 # runs of hits
        "c" + fill * 240 + "a" + fill * 10 + "b",             # no c after b
        "ab" * 600,
    ]
    return rows


LONG_ROWS = (_long_lines(24, seed=8) + datagen.xl_heavy_corpus(
    median_length=2048, num_samples=10, seed=3) + _window_rows()
    + PATHS[:200])
ARABIC_LONG = unicode_sentences.generate(24, median_units=700, seed=9) + [
    "إ" + "ب ت" * 300 + "ن ab", "xy إ" + "ثج " * 250 + "ن",
    "a" + "ب" * 600 + "b", "ab " + "ثج" * 400 + " إن",
    "ä" + "ب" * 600 + "bc", "Ä" + "ب" * 600 + "bc",
    ("ا" * 511) + "ab"]   # 513 codepoints, 1,024 bytes: the DP
HANGUL_LONG = datagen.unicode_corpus(
    "korean", num_samples=16, median_units=500, needle="가나",
    needle_every=2, seed=4) + [
    "가" + "다라" * 200 + "나", "ab 가" + "다 " * 300 + "나다",
    "a" + "다" * 400 + "b", "A" + "다" * 400 + "xb", "가" * 341 + "ab"]


@pytest.mark.parametrize("query,cfg", [
    ("ab", {}), ("abc", {}), ("ab", {"max_typos": 1}),
    ("abc", {"max_typos": 1}), ("ab", {"max_typos": None}),
    ("AB", {}), ("aB", {}), ("fb", {}), ("xab", {"max_typos": 2}),
])
def test_window_edges_and_bonuses(query, cfg):
    """Windows of exactly 1,024 bytes (the DP) and 1,025 (greedy), from
    the row's start (prefix bonus) and a later byte; the delimiter gate;
    capitalization; needles the scan cannot place under a budget."""
    assert_same(_window_rows() + PATHS[:50], query, cfg)


@pytest.mark.parametrize("query,cfg", [
    ("linux", {}), ("browser", {}), ("deadbeef", {}), ("dbf", {}),
    ("deadbeef", {"max_typos": 1}), ("deadbxef", {"max_typos": 2}),
    ("tabstrip", {"max_typos": 3}), ("linux", {"max_typos": None}),
    ("Browser", {}), ("'render", {}), ("^src/", {}), ("cc$", {}),
    ("^deadbeef$", {}), ("!linux", {}), ("linux !browser", {}),
    ("web 'main !^src", {}), ("deadbeef !zzz", {"max_typos": 1}),
])
def test_long_rows(query, cfg):
    """XL rows of 1-16 KB (code search lines and the port's
    ``xl_heavy_corpus`` shape) beside short paths: fuzzy at T=0, T=1-3
    and no budget, literal, negated and multi-atom queries."""
    assert_same(LONG_ROWS, query, cfg, k=256)


@pytest.mark.parametrize("rows,query,cfg", [
    (ARABIC_LONG, "إن", {}), (ARABIC_LONG, "إنب", {"max_typos": 1}),
    (ARABIC_LONG, "ab", {}), (ARABIC_LONG, "إن", {"max_typos": None}),
    (ARABIC_LONG, "ab إن", {}), (ARABIC_LONG, "'إن !ab", {}),
    (ARABIC_LONG, "äbc", {}), (ARABIC_LONG, "Äbc", {}),
    (HANGUL_LONG, "가나", {}), (HANGUL_LONG, "가나다", {"max_typos": 1}),
    (HANGUL_LONG, "ab", {}), (HANGUL_LONG, "Ab", {}),
    (HANGUL_LONG, "가나", {"max_typos": None}),
])
def test_codepoint_rows_over_the_cap(rows, query, cfg):
    """Rows of at most 1,024 codepoints but over 1,024 bytes (2-byte
    Arabic, 3-byte Hangul) take the greedy matcher on their bytes, with
    ASCII and non-ASCII needles."""
    assert_same(rows, query, cfg, k=64)


@pytest.mark.parametrize("mix", ["paths_fuzzy", "paths_allscores",
                                 "paths_syntax", "sentences_fuzzy"])
def test_generated_queries_long_rows(mix):
    """Twelve distinct queries of one generated batch of each mix over a
    long-row corpus, with the mix's own Config fields."""
    rows = ARABIC_LONG if mix == "sentences_fuzzy" else LONG_ROWS
    m = load_json(HERE, "traffic", f"{mix}.json")
    gen = load_module("traffic", m["generator"])
    batches, _ = gen.generate(rows, m["params"], 1, rng_for(11, 1))
    for q in sorted(set(batches[0]))[:12]:
        assert_same(rows, q, m["config"], k=64)


@pytest.fixture(scope="module")
def long_served():
    """Two generated batches of the fuzzy paths mix over ``LONG_ROWS``,
    served by the port's batched path on the CPU (XL rows scored on the
    host, greedy windows rescored)."""
    from frizbee_tpu_torch import match_topk_batch, pack_corpus

    m = load_json(HERE, "traffic", "paths_fuzzy.json")
    batches, _ = load_module("traffic", m["generator"]).generate(
        LONG_ROWS, m["params"], 2, rng_for(13, 1))
    corpus = pack_corpus(LONG_ROWS, unicode=False, device="cpu")
    served = [match_topk_batch(b, corpus, Config(**m["config"]), 64)
              for b in batches]
    ref = Corpus(LONG_ROWS, "cpu")
    return (m["config"], batches, served, ref,
            check.reference_for(ref, m["config"], 64))


@pytest.mark.parametrize("fault", ["sound", "control", *check.FAULTS])
def test_long_rows_check(long_served, fault):
    """The check on long rows: the port's served answers are correct;
    the control (the reference, ties reversed) and each planted fault are
    not."""
    config, batches, served, ref, reference = long_served
    ledger = check.Ledger(sorted({q for b in batches for q in b}))
    previous = None
    for batch, answers in zip(batches, served):
        if fault == "control":
            got = [answer(ref, q, config, 64, ties="desc") for q in batch]
        elif fault in check.FAULTS:
            got = check.FAULTS[fault](answers, previous)
        else:
            got = answers
        ledger.record(batch, got)
        previous = answers
    out = ledger.compare(reference)
    assert out["answers_checked"] == sum(map(len, batches))
    bad = out["wrong_answers"] + out["missing_answers"]
    assert (bad == 0) if fault == "sound" else (bad > 0)
