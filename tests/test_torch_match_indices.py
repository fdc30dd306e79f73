"""The port's matched-character index APIs against frizbee_tpu's:
``Matcher.match_list_indices`` / ``match_one_indices`` /
``match_iter_indices`` and the one-shot ``match_list_indices`` and
``fuzzy_match_indices``. The port runs with ``device="cpu"`` (the match
set from ``match_arrays``' plain versions, then the host traceback) and
with ``use_device=False`` (the host oracle); the reference with
``use_device=True`` (Pallas in interpret mode, then its traceback) and
``use_device=False``. Fuzzy needles below and past the batched walk's 32
matches, literal modes, multi-pattern and negated queries, an Arabic
needle, the empty query, every sort strategy, and the iterators over
strings in chunks and over a ``Corpus``.

Inputs are made from a seed, the same in both packages; every comparison
has zero tolerance: score, index, exact and the reversed byte indices,
entry by entry, in order."""

import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu_torch.traceback as ttb
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.datagen import HaystackGenerationOptions as JOptions
from frizbee_tpu.datagen import generate_haystack as j_generate
from frizbee_tpu.datagen import unicode_corpus as j_unicode_corpus
from frizbee_tpu_torch import (
    Config,
    Matcher,
    SortStrategy,
    datagen,
    fuzzy_match_indices,
    match_list_indices,
    pack_corpus,
)

OPTIONS = dict(seed=23, partial_match_percentage=0.4, match_percentage=0.3,
               median_length=32, std_dev_length=20, num_samples=500)
# rows for the anchored and exact literal modes and the casing bonuses
EXTRA = ["deadbeef", "DeadBeef", "dead_beef", "xx dead beef", "foo", "foobar",
         "barfoo", "FooBar", "beef dead", "deadbeef!"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hay():
    got = datagen.generate_haystack(
        "deadbeef", datagen.HaystackGenerationOptions(**OPTIONS))
    assert got == j_generate("deadbeef", JOptions(**OPTIONS))
    return got + EXTRA


@pytest.fixture(scope="module")
def arabic():
    kw = dict(num_samples=300, median_units=16, needle="إن", needle_every=3,
              seed=6)
    got = datagen.unicode_corpus("arabic", **kw)
    assert got == j_unicode_corpus("arabic", **kw)
    return got


def _jcfg(cfg):
    return JConfig(**{k: JSortStrategy[v.name] if k == "sort" else v
                      for k, v in cfg.items()})


def _rows(ms):
    return [(m.score, m.index, m.exact, list(m.indices)) for m in ms]


def _assert_all_equal(query, hay, unicode=False, **cfg):
    """The port on the CPU (strings and a CPU Corpus) and its oracle
    against the reference's device path and its oracle. Returns the
    port's rows."""
    want = _rows(jm.Matcher.from_query(query, _jcfg(cfg)).match_list_indices(
        hay))
    assert want == _rows(jm.Matcher.from_query(
        query, _jcfg(cfg), use_device=False).match_list_indices(hay))
    corpus = pack_corpus(hay, unicode=unicode, device="cpu")
    for got in (
        Matcher.from_query(query, Config(**cfg),
                           device="cpu").match_list_indices(hay),
        Matcher.from_query(query, Config(**cfg)).match_list_indices(corpus),
        Matcher.from_query(query, Config(**cfg),
                           use_device=False).match_list_indices(hay),
    ):
        assert _rows(got) == want
    return want


@pytest.fixture
def batched_calls(monkeypatch):
    """The row counts handed to the batched walk."""
    calls = []
    inner = ttb.batched_match_indices

    def spy(engine, rows):
        calls.append(len(rows))
        return inner(engine, rows)

    monkeypatch.setattr(ttb, "batched_match_indices", spy)
    return calls


@pytest.mark.parametrize("query,cfg,rows,batched", [
    ("deadbeef", {}, 40, False),      # under 32 matches: the per-row oracle
    ("deadbeef", {}, None, True),
    ("deadbeef", {"max_typos": 1}, None, True),
    ("deadbeef", {"max_typos": None}, None, True),
    ("DeadBeef", {}, None, False),    # smart case: few matches
    ("dead", {"sort": SortStrategy.SCORE_THEN_INDEX_DESC}, None, True),
])
def test_fuzzy_indices(hay, batched_calls, query, cfg, rows, batched):
    got = _assert_all_equal(query, hay[:rows], **cfg)
    assert len(got) > 0 and (len(got) >= 32) == batched
    # the device-mode calls (strings, Corpus) take the batched walk
    assert len(batched_calls) == (2 if batched else 0)
    assert all(n == len(got) for n in batched_calls)


@pytest.mark.parametrize("query", ["^dead", "beef$", "'dead", "^deadbeef$"])
def test_literal_indices(hay, batched_calls, query):
    got = _assert_all_equal(query, hay)
    assert len(got) > 0 and not batched_calls
    for score, index, exact, inds in got:
        assert len(inds) == len(query.strip("^$'"))


@pytest.mark.parametrize("query", ["dead beef", "dead !^beef", "!dead",
                                   "'dead !beef$"])
def test_multi_and_negated_indices(hay, batched_calls, query):
    got = _assert_all_equal(query, hay)
    assert len(got) > 0 and not batched_calls
    for *_s, inds in got:
        assert all(a > b for a, b in zip(inds, inds[1:]))


def test_overlapping_atoms_deduped():
    # frizbee_tpu's tests/test_matcher_api.py overlapping-atoms case
    got = _assert_all_equal("foo fo", ["foo", "xfoo", "bar"] * 12)
    assert got[0][3] == [2, 1, 0]


def test_arabic_indices(arabic, batched_calls):
    got = _assert_all_equal("إن", arabic, unicode=True)
    assert len(got) >= 32 and len(batched_calls) == 2


@pytest.mark.parametrize("sort", list(SortStrategy))
def test_empty_query(hay, sort):
    got = _assert_all_equal("", hay[:50], sort=sort)
    assert [r[1] for r in got] == (list(range(49, -1, -1))
                                   if sort.is_reversed else list(range(50)))


@pytest.mark.parametrize("sort", list(SortStrategy))
def test_sort_strategies(hay, sort):
    """Every strategy, on the host oracle and on the device path (index
    sorts through the generic body, refused before it was ported, with
    match_iter_indices in input order), equals the reference's device
    path and oracle."""
    cfg = {"sort": sort}
    want = _rows(jm.Matcher.from_query("deadbeef", _jcfg(cfg))
                 .match_list_indices(hay))
    got = Matcher.from_query("deadbeef", Config(**cfg), use_device=False)
    assert _rows(got.match_list_indices(hay)) == want and want
    assert want == _rows(jm.Matcher.from_query(
        "deadbeef", _jcfg(cfg), use_device=False).match_list_indices(hay))
    dev = Matcher.from_query("deadbeef", Config(**cfg), device="cpu")
    assert _rows(dev.match_list_indices(hay)) == want
    if not sort.is_by_score:
        assert _rows(dev.match_iter_indices(hay)) == _rows(
            jm.Matcher.from_query("deadbeef", _jcfg(cfg))
            .match_iter_indices(hay))


@pytest.mark.parametrize("query,cfg", [
    ("deadbeef", {}),
    ("dead !^beef", {}),
    ("deadbeef", {"max_typos": 1}),
])
def test_match_iter_indices(hay, query, cfg):
    """Strings in several chunks (the index rebased by each chunk's base),
    a Corpus in one call, and the host oracle, in input order, against
    the reference's iterator."""
    want = _rows(jm.Matcher.from_query(query, _jcfg(cfg)).match_iter_indices(
        hay))
    assert want and [r[1] for r in want] == sorted(r[1] for r in want)
    m = Matcher.from_query(query, Config(**cfg), device="cpu")
    m.iter_chunk = 128
    assert _rows(m.match_iter_indices(hay)) == want
    assert _rows(m.match_iter_indices(iter(hay))) == want
    assert _rows(m.match_iter_indices(
        pack_corpus(hay, device="cpu"))) == want
    assert _rows(Matcher.from_query(query, Config(**cfg), use_device=False)
                 .match_iter_indices(hay)) == want
    # the iterator and the list hold the same entries
    listed = _rows(m.match_list_indices(hay))
    assert sorted(listed, key=lambda r: r[1]) == want


def test_one_shot_functions(hay):
    want = _rows(jm.match_list_indices("deadbeef", hay))
    assert _rows(match_list_indices("deadbeef", hay, device="cpu")) == want
    assert _rows(match_list_indices("deadbeef", hay,
                                    use_device=False)) == want
    want = _rows(jm.fuzzy_match_indices(hay, "deadbeef"))
    assert want
    # an unsized iterable: chunks of 32, 128 and 512 rows
    assert _rows(fuzzy_match_indices(iter(hay), "deadbeef",
                                     device="cpu")) == want
    assert _rows(fuzzy_match_indices(hay, "deadbeef",
                                     use_device=False)) == want


def test_match_one_indices(hay):
    """The per-row entry point, row by row, against the reference's."""
    for query in ("deadbeef", "dead !^beef", "^dead", "foo fo"):
        m = Matcher.from_query(query, device="cpu")
        jmat = jm.Matcher.from_query(query)
        for i, h in enumerate(hay[:120] + EXTRA):
            a, b = m.match_one_indices(h, i), jmat.match_one_indices(h, i)
            assert (a is None) == (b is None)
            if a is not None:
                assert _rows([a]) == _rows([b])
    assert Matcher.from_query("").match_one_indices("x", 3).index == 3

