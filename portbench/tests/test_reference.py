"""The plain reference against the port's host oracle
(``frizbee_tpu_torch.Matcher(use_device=False)``) on small corpora, for
the query shapes of every traffic generator: fuzzy at T=0, T>0 and
``max_typos=None``, literal modes, negated and multi-atom queries, byte
and codepoint rows."""

import numpy as np
import pytest

from frizbee_tpu_torch import Config, Matcher
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
