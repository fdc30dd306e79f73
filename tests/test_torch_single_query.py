"""The port's single-query Matcher API against frizbee_tpu: ``match_arrays``
(the batched program at Q=1 over the tiered result window, with Pallas in
interpret mode on the reference's side) against the reference's
``Matcher(use_device=True)`` and its host oracle ``Matcher(use_device=False)``
for fuzzy, literal, long, multi-pattern and unicode needles; the window's
overflow re-dispatch and the second fetch; the empty query's copy path
and the unit-mode repack; config and pattern changes; the per-corpus
dispatch cache; ``match_iter``, ``match_list_parallel``, ``k_merge`` and
``match_one``; the batch entry points' per-query fallbacks; and the host
oracle's own cases (index sorts, needles over 64 units, atoms of mixed
unit modes).

Inputs are made from a seed and handed to both packages; every
comparison has zero tolerance (integer and boolean arrays, element for
element)."""

import gc
import pickle

import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu_torch.matcher as tm
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.config import UnicodeMatching as JUnicodeMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.pattern import Pattern as JPattern
from frizbee_tpu_torch import (
    Config,
    Matcher,
    Pattern,
    SortStrategy,
    UnicodeMatching,
    datagen,
    fuzzy_match,
    match_arrays_batch,
    match_list,
    match_list_parallel,
    match_topk_batch,
    pack_corpus,
)

LONG_NEEDLE = "deadbeefcafebabefacefeed"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _corpora(hay, unicode=False):
    return (hay, pack_corpus(hay, unicode=unicode, device="cpu"),
            j_pack(hay, unicode=unicode))


@pytest.fixture(scope="module")
def partial():
    # the Partial Match dataset, plus rows holding the long needle
    return _corpora(datagen.partial_match_corpus(
        median_length=20, num_samples=3000, seed=3)
        + [f"{i}_{LONG_NEEDLE}" for i in range(30)])


@pytest.fixture(scope="module")
def arabic():
    return _corpora(datagen.unicode_corpus(
        "arabic", num_samples=2000, median_units=18, needle="إن", seed=9,
    ), unicode=True)


def _jcfg(cfg):
    out = {}
    for key, v in cfg.items():
        if key == "sort":
            v = JSortStrategy[v.name]
        elif key == "unicode":
            v = JUnicodeMatching[v.name]
        out[key] = v
    return JConfig(**out)


def _assert_cols(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _assert_three_way(query, corpora, **cfg):
    """The port's match_arrays on the CPU corpus against the reference's
    device path and its host oracle, and the port's own oracle against
    the reference's. Returns the port's columns."""
    hay, port, ref = corpora
    got = Matcher.from_query(query, Config(**cfg)).match_arrays(port)
    want = jm.Matcher.from_query(query, _jcfg(cfg)).match_arrays(ref)
    oracle = jm.Matcher.from_query(
        query, _jcfg(cfg), use_device=False).match_arrays(ref)
    _assert_cols(got, want)
    _assert_cols(got, oracle)
    _assert_cols(Matcher.from_query(
        query, Config(**cfg), use_device=False).match_arrays(hay), oracle)
    return got


@pytest.mark.parametrize("query,cfg", [
    ("deadbeef", {}),
    ("deadbeef", {"max_typos": 1}),
    ("deadbeef", {"max_typos": 4}),
    ("deadbeef", {"sort": SortStrategy.SCORE_THEN_INDEX_DESC}),
    ("'dead", {}),
    ("^dead", {}),
    ("beef$", {}),
    ("^deadbeef$", {}),
    (LONG_NEEDLE, {}),
    ("dead !^beef", {}),
])
def test_match_arrays_parity(partial, query, cfg):
    got = _assert_three_way(query, partial, **cfg)
    if "$" not in query and "!" not in query:
        assert len(got[0]) > 0


def test_match_arrays_arabic(arabic):
    assert len(_assert_three_way("إن", arabic)[0]) > 0


def test_window_overflow_and_second_fetch(partial, monkeypatch):
    """A count beyond the tiered window re-dispatches once with the full
    window; a count beyond fetch_rows takes the second copy. The window
    floor is shrunk in both packages so a 3000-row corpus overflows."""
    _hay, port, ref = partial
    monkeypatch.setattr(tm, "Q1_WINDOW_MIN", 64)
    monkeypatch.setattr(jm, "Q1_WINDOW_MIN", 64)
    calls = []
    dispatch = tm.Matcher._fused_dispatch

    def spy(self, corpus, full_window=False, prep=None):
        calls.append(full_window)
        return dispatch(self, corpus, full_window, prep)

    monkeypatch.setattr(tm.Matcher, "_fused_dispatch", spy)
    for fetch_rows in (8192, 16):
        m = Matcher.from_query("e")
        jmat = jm.Matcher.from_query("e")
        m.fetch_rows = jmat.fetch_rows = fetch_rows
        calls.clear()
        got = m.match_arrays(port)
        assert len(got[0]) > max(64, len(port) // 8)
        assert calls == [False, True]
        _assert_cols(got, jmat.match_arrays(ref))
    # within the tier: one dispatch, and the second copy past fetch_rows
    m, jmat = Matcher.from_query("deadbeef"), jm.Matcher.from_query("deadbeef")
    m.fetch_rows = jmat.fetch_rows = 16
    calls.clear()
    got = m.match_arrays(port)
    assert calls == [False] and len(got[0]) > 16
    _assert_cols(got, jmat.match_arrays(ref))


def test_empty_query_and_repack(partial, arabic):
    """The empty query's copy path, and a needle of the other unit mode
    than the corpus (repacked on the corpus device), as the reference."""
    hay, port, ref = partial
    for sort in (SortStrategy.SCORE_THEN_INDEX_ASC, SortStrategy.INDEX_DESC):
        cfg = {"sort": sort}
        got = Matcher.from_query("", Config(**cfg)).match_arrays(port)
        _assert_cols(got, jm.Matcher.from_query(
            "", _jcfg(cfg)).match_arrays(ref))
        ml = Matcher.from_query("", Config(**cfg)).match_list(hay)
        assert len(ml) == len(hay) and ml[0].index == got[0][0]
    ahay, aport, aref = arabic
    _assert_cols(
        Matcher.from_query("abc").match_arrays(aport),
        jm.Matcher.from_query("abc").match_arrays(aref))
    got = Matcher.from_query("إن").match_arrays(
        pack_corpus(ahay, device="cpu"))
    _assert_cols(got, jm.Matcher.from_query("إن").match_arrays(
        j_pack(ahay, unicode=False)))
    assert len(got[0]) > 0


def test_config_and_pattern_changes(partial):
    """set_config, set_pattern, set_patterns and from_patterns rebuild the
    compiled patterns and reset the dispatch cache; results equal the
    reference's (its device path, then its oracle) and fresh matchers'."""
    hay, port, ref = partial
    m = Matcher.from_query("deadbeef")
    jmat = jm.Matcher.from_query("deadbeef")
    m.match_arrays(port)
    assert len(m._dispatch_cache) == 1
    m.set_config(Config(max_typos=1))
    jmat.set_config(JConfig(max_typos=1))
    assert m.config == Config(max_typos=1) and not m._dispatch_cache
    _assert_cols(m.match_arrays(port), jmat.match_arrays(ref))
    oracle = jm.Matcher.from_query("deadbeef", JConfig(max_typos=1),
                                   use_device=False)
    m.set_pattern("dead")
    oracle.set_pattern("dead")
    assert [p.needle for p in m.patterns] == ["dead"]
    _assert_cols(m.match_arrays(port), oracle.match_arrays(hay))
    m.set_patterns([Pattern.parse("dead"), Pattern.parse("!beef")])
    oracle.set_patterns([JPattern.parse("dead"), JPattern.parse("!beef")])
    _assert_cols(m.match_arrays(port), oracle.match_arrays(hay))
    m2 = Matcher.from_patterns(m.patterns, m.config)
    _assert_cols(m2.match_arrays(port), m.match_arrays(port))
    cache = m._dispatch_cache
    m.set_patterns(m.patterns)  # unchanged: no rebuild
    assert m._dispatch_cache is cache


def test_dispatch_cache_reuse_and_eviction(partial, monkeypatch):
    """The Q=1 preparation runs once per (corpus, window); dropping the
    corpus evicts its entry; a fifth corpus clears the cache."""
    hay, port, _ref = partial
    prepared = []
    prepare = tm.Matcher._fused_prepare

    def spy(self, corpus, full_window):
        prepared.append(full_window)
        return prepare(self, corpus, full_window)

    monkeypatch.setattr(tm.Matcher, "_fused_prepare", spy)
    m = Matcher.from_query("deadbeef")
    first = m.match_arrays(port)
    _assert_cols(m.match_arrays(port), first)
    assert prepared == [False] and list(m._dispatch_cache) == [
        (id(port), False)]
    small = [pack_corpus(hay[:200 + i], device="cpu") for i in range(4)]
    for c in small[:3]:
        m.match_arrays(c)
    assert len(m._dispatch_cache) == 4
    m.match_arrays(small[3])
    assert list(m._dispatch_cache) == [(id(small[3]), False)]
    del small, c
    gc.collect()
    assert not m._dispatch_cache


def test_match_iter(partial):
    """match_iter over a Corpus and over strings (sized, in chunks of
    iter_chunk, and an unsized generator with its growing warm-up
    chunks) yields the reference's matches in input order."""
    hay, port, ref = partial
    want = [(x.score, x.index, x.exact, x.end_col)
            for x in jm.Matcher.from_query("deadbeef").match_iter(ref)]
    oracle = [(x.score, x.index, x.exact, x.end_col)
              for x in jm.Matcher.from_query(
                  "deadbeef", use_device=False).match_iter(hay)]
    assert want == oracle and want
    m = Matcher.from_query("deadbeef", device="cpu")
    m.iter_chunk = 700
    for src in (port, hay, iter(hay)):
        got = [(x.score, x.index, x.exact, x.end_col)
               for x in m.match_iter(src)]
        assert got == want
    got = [(x.score, x.index, x.exact, x.end_col) for x in fuzzy_match(
        hay, "deadbeef", use_device=False)]
    assert got == want


def test_match_list_parallel_k_merge_match_one(partial):
    hay, _port, ref = partial
    want = jm.match_list_parallel("dead", hay, 4, use_device=False)
    for shards in (1, 2, 4):
        got = match_list_parallel("dead", hay, shards, device="cpu")
        assert [m.to_dict() for m in got] == [m.to_dict() for m in want]
    ml = match_list("dead", hay, device="cpu")
    assert [m.to_dict() for m in ml] == [m.to_dict() for m in want]
    with pytest.raises(ValueError):
        Matcher("dead").match_list_parallel(hay, 0)
    runs = [Matcher("dead", device="cpu").match_list(hay[s:s + 1000])
            for s in (0, 1000, 2000)]
    jruns = [jm.Matcher("dead", use_device=False).match_list(hay[s:s + 1000])
             for s in (0, 1000, 2000)]
    for sort in SortStrategy:
        got = tm.k_merge([list(r) for r in runs], sort)
        exp = jm.k_merge([list(r) for r in jruns], JSortStrategy[sort.name])
        assert [m.to_dict() for m in got] == [m.to_dict() for m in exp]
    for query in ("deadbeef", "dead !^beef", ""):
        m, jmat = Matcher.from_query(query), jm.Matcher.from_query(query)
        for i, h in enumerate(hay[:300]):
            a, b = m.match_one(h, i), jmat.match_one(h, i)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.to_dict() == b.to_dict()


def test_batch_fallbacks(partial):
    """match_arrays_batch and match_topk_batch send the queries no group
    takes (empty, another unit mode) and overflowing ones through the
    per-query path, as the reference does."""
    _hay, port, ref = partial
    queries = ["deadbeef", "", "إن", "e"]
    got = match_arrays_batch(queries, port, fetch_rows=64)
    want = jm.match_arrays_batch(queries, ref, fetch_rows=64)
    for g, w in zip(got, want):
        _assert_cols(g, w)
    assert len(got[3][0]) > 64 and len(got[1][0]) == len(port)
    topk = match_topk_batch(queries, port, k=64)
    jtopk = jm.match_topk_batch(queries, ref, k=64)
    for g, w in zip(topk, jtopk):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_greedy_risk_past_k_full_fetch():
    """On a corpus that can produce greedy rows, a count past k takes the
    per-query full fetch (formerly refused) and equals the reference."""
    hay = ["a" + "€" * 400 + "b", "ab", "xaxb", "ab ab", "€ab"]
    cfg = {"unicode": UnicodeMatching.ALWAYS}
    corpus = pack_corpus(hay, unicode=True, device="cpu")
    assert corpus.greedy_risk()
    got = match_topk_batch(["ab"], corpus, Config(**cfg), k=2)
    want = jm.match_topk_batch(["ab"], j_pack(hay, unicode=True),
                               _jcfg(cfg), k=2)
    assert got[0][0] == want[0][0] > 2
    for a, b in zip(got[0][1:], want[0][1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("query,cfg", [
    ("dead", {"sort": SortStrategy.INDEX_ASC}),
    ("dead !^beef", {"sort": SortStrategy.INDEX_DESC}),
    ("deadbeef" * 8 + "a", {}),
    ("abc إن", {}),
    ("^" + "é" * 17, {}),
])
def test_host_oracle_serves_generic_queries(query, cfg):
    """Under use_device=False the port serves the generic queries equal to
    the reference's oracle, and under use_device=True (refused before the
    generic pipelines were ported) equal to the reference's device
    path."""
    rows = datagen.partial_match_corpus(median_length=20, num_samples=300,
                                        seed=4)
    rows = rows + ["abc إن" + r for r in rows[:40]] + ["é" * 18, "deadbeef" * 9]
    got = Matcher.from_query(query, Config(**cfg), use_device=False)
    want = jm.Matcher.from_query(query, _jcfg(cfg), use_device=False)
    _assert_cols(got.match_arrays(rows), want.match_arrays(rows))
    _assert_cols(got.match_arrays(pack_corpus(rows, device="cpu")),
                 want.match_arrays(rows))
    assert len(got.match_arrays(rows)[0]) > 0
    _assert_cols(
        Matcher.from_query(query, Config(**cfg)).match_arrays(
            pack_corpus(rows, device="cpu")),
        jm.Matcher.from_query(query, _jcfg(cfg)).match_arrays(rows))


def test_head_slice_only(partial, monkeypatch):
    """Only the count and the first fetch_rows rows of the window are
    handed to the host copy; the rest stays with the device result."""
    _hay, port, _ref = partial
    m = Matcher.from_query("dead")
    m.fetch_rows = 32
    _corpus, out, host, ready = m._fused_dispatch(port)
    assert out.shape[0] == 1 + len(port) and host.shape[0] == 1 + 32
    assert ready is None and torch.equal(host, out[:33])


def test_match_list_pickle_roundtrip(partial):
    _hay, port, _ref = partial
    ml = Matcher.from_query("deadbeef").match_list(port)
    back = pickle.loads(pickle.dumps(list(ml)))
    assert back == ml and ml == back
