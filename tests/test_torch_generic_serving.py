"""Generic-pipeline serving in the port against frizbee_tpu, slice by slice:
the raw (Q, 1 + k, 2) arrays of both packages' ``_dispatch_batch_groups``
and the decoded ``match_topk_batch`` results for index sorts (byte and
codepoint rows), multi-pattern queries with an atom beyond the
column-stream budgets, needles over 64 units, budgets over 8 and custom
bucket widths; ``Matcher.match_arrays`` / ``match_list`` /
``match_list_indices`` under every ``SortStrategy``; atoms of mixed unit
modes; the fuzzy engine's device ``match_corpus`` over greedy and XL
rows; and the two faults this slice made reachable (the finalize-cap
chooser over a bucket wider than 1024, and the end_col width guard).
Each result is held to the reference's ``use_device=True`` path and to
its host oracle (``use_device=False``); the generic route each batch
took is asserted through ``ops.batch.GENERIC_ROUTES``.

Inputs are made from a seed and handed to both packages; every
comparison has zero tolerance."""

import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.config import UnicodeMatching as JUnicodeMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import make_engine as j_make_engine
from frizbee_tpu_torch import (
    Config,
    Matcher,
    SortStrategy,
    UnicodeMatching,
    datagen,
    match_topk_batch,
    pack_corpus,
)
from frizbee_tpu_torch.engine import make_engine


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(cfg):
    """(port Config, reference Config) of one option dict, enums by
    name."""
    tk, jk = {}, {}
    for key, v in cfg.items():
        if key == "sort":
            tk[key], jk[key] = SortStrategy[v], JSortStrategy[v]
        elif key == "unicode":
            tk[key], jk[key] = UnicodeMatching[v], JUnicodeMatching[v]
        else:
            tk[key] = jk[key] = v
    return Config(**tk), JConfig(**jk)


def _corpora(hay, unicode=False, widths=None):
    kw = {} if widths is None else {"bucket_widths": widths}
    return (hay, pack_corpus(hay, unicode=unicode, device="cpu", **kw),
            j_pack(hay, unicode=unicode, **kw))


def _partial_hay():
    hay = datagen.partial_match_corpus(median_length=20, num_samples=500,
                                       seed=31)
    return hay + ["DeadBeef_" + h for h in hay[:30]] + ["x" * 1500 + "dead"]


@pytest.fixture(scope="module")
def partial():
    return _corpora(_partial_hay())


@pytest.fixture(scope="module")
def arabic():
    hay = datagen.unicode_corpus("arabic", num_samples=400, needle="إن",
                                 needle_every=6, seed=32)
    return _corpora(hay + ["إن abc " + h for h in hay[:20]], unicode=True)


def _serve_both(corpora, queries, k, route, groups=1, **cfg):
    """Raw arrays of both dispatchers (group by group), then the decoded
    top-k against the reference's and its oracle; asserts the generic
    route every group took."""
    hay, port, ref = corpora
    tcfg, jcfg = _cfgs(cfg)
    before = dict(tbatch.GENERIC_ROUTES)
    pending = tm._dispatch_batch_groups(
        [Matcher.from_query(q, tcfg) for q in queries], port, tcfg, k)
    jpending, _ = jm._dispatch_batch_groups(
        [jm.Matcher.from_query(q, jcfg) for q in queries], ref, jcfg, k)
    assert len(pending) == len(jpending) == groups
    for (got, _r, members), (want, jmembers) in zip(pending, jpending):
        assert members == jmembers
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tbatch.GENERIC_ROUTES[route] == before[route] + groups
    got = match_topk_batch(queries, port, tcfg, k=k)
    want = jm.match_topk_batch(queries, ref, jcfg, k=k)
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0], q
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
        oracle = jm.Matcher.from_query(
            q, jcfg, use_device=False).match_arrays(hay)
        assert g[0] == len(oracle[0]), q
        # under INDEX_DESC the top k are the k smallest matched indices,
        # reversed (the reference's fetch runs in ascending order)
        desc = cfg.get("sort") == "INDEX_DESC" and g[0] > k
        for a, b in zip(g[1:], oracle):
            np.testing.assert_array_equal(a, b[-k:] if desc else b[:k])
    return got


def _perms(word, count, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.permutation(list(word))) for _ in range(count)]


@pytest.mark.parametrize("sort", ["INDEX_ASC", "INDEX_DESC"])
def test_index_sort_bytes(partial, sort):
    """Fuzzy permutations of "deadbeef" under an index sort: the generic
    body over the row-major kernel."""
    got = _serve_both(partial, ["deadbeef"] + _perms("deadbeef", 3, 1), 25,
                      "kernel_body", sort=sort)
    assert got[0][0] > 25


def test_generic_body_in_body_sort(partial, monkeypatch):
    """Past the batched-sort budget the generic body sorts each query's
    keys on its own: the same arrays (budget lowered in both packages;
    the reference's generic scan sorts a query at a time always)."""
    import frizbee_tpu.ops.batch as jbatch

    monkeypatch.setattr(jbatch, "SORT_BODY_BUDGET", 1 << 10)
    monkeypatch.setattr(tbatch, "SORT_BODY_BUDGET", 1 << 10)
    _serve_both(partial, ["deadbeef", "beefdead"], 25, "kernel_body",
                sort="INDEX_DESC")


def test_index_sort_typos(partial):
    _serve_both(partial, ["dbeef", "dfeed"], 40, "kernel_body",
                sort="INDEX_ASC", max_typos=1)


@pytest.mark.parametrize("sort", ["INDEX_DESC", "SCORE_THEN_INDEX_DESC"])
def test_index_sort_codepoints(arabic, sort):
    """Arabic fuzzy needles: INDEX_DESC takes the generic body over
    codepoint rows; SCORE_THEN_INDEX_DESC is a score sort (the colstream
    flow, then the host reorder)."""
    queries = ["إن", "نإ", "ان"]
    if sort == "INDEX_DESC":
        _serve_both(arabic, queries, 30, "kernel_body", sort=sort)
        return
    tcfg, jcfg = _cfgs({"sort": sort})
    got = match_topk_batch(queries, arabic[1], tcfg, k=30)
    want = jm.match_topk_batch(queries, arabic[2], jcfg, k=30)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_multi_long_atom(partial):
    """A 20-unit fuzzy atom beside a negated literal: the generic body
    (fuzzy atom through fuzzy_match_units, literal through the literal
    pipeline)."""
    _serve_both(partial, ["deadbeefcafebabefeed !^dead",
                          "deadbeefcafebabefade !^beef"], 30, "kernel_body")


def test_long_needle_and_large_budget(partial):
    """A needle over 64 units, and a budget over 8 on a needle of more
    than 8 units: use_kernel is false, the pipeline body serves."""
    hay = partial[0]
    row = next(h for h in hay if len(h) >= 65)
    _serve_both(partial, [row[:65]], 10, "pipeline_body")
    _serve_both(partial, ["deadbeefda", "feedbeadda"], 20, "pipeline_body",
                max_typos=9)


@pytest.mark.parametrize("widths,sort", [((48,), "SCORE_THEN_INDEX_ASC"),
                                         ((64, 128, 2048), "INDEX_DESC")])
def test_custom_bucket_widths(widths, sort):
    """Widths the kernels do not hold (48, and a 2048 bucket)."""
    hay = datagen.partial_match_corpus(median_length=20, num_samples=400,
                                       seed=33)
    hay += ["dead" + "x" * 300 + "beef", "x" * 3000]
    corpora = _corpora(hay, widths=widths)
    assert max(b.width for b in corpora[1].buckets) == max(widths)
    _serve_both(corpora, ["dead", "beef"], 30, "pipeline_body", sort=sort)


@pytest.mark.parametrize("sort", list(SortStrategy))
@pytest.mark.parametrize("query", ["deadbeef", "dead !^beef", "^deadbeefdeadbeefd"])
def test_matcher_apis_every_sort(partial, sort, query):
    """match_arrays, match_list and match_list_indices under every sort
    strategy, equal to the reference's device path and its oracle."""
    hay, port, ref = partial
    tcfg, jcfg = _cfgs({"sort": sort.name})
    m = Matcher.from_query(query, tcfg)
    got = m.match_arrays(port)
    for use_device in (True, False):
        want = jm.Matcher.from_query(query, jcfg, use_device=use_device) \
            .match_arrays(ref if use_device else hay)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert [x.index for x in m.match_list(port)] == list(got[0])
    it = [(x.index, x.score, x.exact, x.end_col) for x in
          Matcher.from_query(query, tcfg, device="cpu").match_iter(hay)]
    assert it == [(x.index, x.score, x.exact, x.end_col) for x in
                  jm.Matcher.from_query(query, jcfg).match_iter(hay)]
    jmi = jm.Matcher.from_query(query, jcfg).match_list_indices(hay)
    tmi = Matcher.from_query(query, tcfg, device="cpu") \
        .match_list_indices(hay)
    assert [(x.index, x.score, x.exact, list(x.indices)) for x in tmi] == [
        (x.index, x.score, x.exact, list(x.indices)) for x in jmi]


@pytest.mark.parametrize("query", ["abc إن", "إن 'dead", "!إن dead"])
def test_mixed_unit_mode_atoms(query):
    """Atoms of both unit modes: each engine's device match_corpus over a
    corpus packed in its own mode (the other packing is made on the
    corpus device), combined on the host."""
    hay = datagen.partial_match_corpus(median_length=16, num_samples=200,
                                       seed=34)
    hay = hay + ["abc إن " + h for h in hay[:30]] + ["إن deadbeef"]
    for port_in in (pack_corpus(hay, device="cpu"),
                    pack_corpus(hay, unicode=True, device="cpu")):
        got = Matcher.from_query(query).match_arrays(port_in)
        for use_device in (True, False):
            want = jm.Matcher.from_query(query, use_device=use_device) \
                .match_arrays(hay)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert len(got[0]) > 0 or query.startswith("!")


def test_fuzzy_engine_device_greedy_and_xl():
    """FuzzyEngine.match_corpus on the device: greedy rows (multi-byte
    rows past the DP cap) and XL rows rescored on the host, equal to the
    reference's engine on both of its branches."""
    rng = np.random.default_rng(35)
    hay = ["a" + "€" * int(k) + "b" for k in rng.integers(400, 900, 8)]
    hay += ["ab", "xaxb", "€ab", "a" * 1500 + "b"]
    hay += datagen.unicode_corpus("arabic", num_samples=60, seed=36)
    port = pack_corpus(hay, unicode=True, bucket_widths=(64, 1024),
                       device="cpu")
    ref = j_pack(hay, unicode=True, bucket_widths=(64, 1024))
    assert port.greedy_risk() and len(port.xl_indices) == 1
    for typos in (0, 1):
        tcfg, jcfg = _cfgs({"unicode": "ALWAYS", "max_typos": typos})
        got = make_engine("ab", tcfg).match_corpus(port)
        for use_device in (True, False):
            want = j_make_engine("ab", jcfg, use_device).match_corpus(ref)
            for f in ("matched", "score", "exact", "end_col"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
        assert got.matched[:8].all()


def test_finalize_cap_counts_wide_buckets_alive():
    """The cap chooser counts a bucket wider than 1024 as all alive, as
    the reference does (the parent counted its presence planes), on a
    corpus whose wide bucket has groups no query's stage 1 keeps."""
    rng = np.random.default_rng(37)
    hay = ["".join(rng.choice(list("abcdef"), 24)) for _ in range(3000)]
    hay += ["".join(rng.choice(list("uvwxyz"), int(k)))
            for k in rng.integers(1100, 1400, 1200)]
    port = pack_corpus(hay, bucket_widths=(32, 2048), device="cpu")
    ref = j_pack(hay, unicode=False, bucket_widths=(32, 2048))
    assert [b.width for b in port.buckets] == [32, 2048]
    def needles(*queries):
        return np.stack([
            np.concatenate(Matcher.from_query(q)._compiled[0].engine
                           ._host_needle()[:2])
            for q in queries
        ])

    caps = []
    for queries in (("abcd", "fade"), ("uvwx", "wxyz")):
        entries = [(needles(*queries), 0)]
        got = tm._colstream_finalize_cap(port, entries, 8)
        want = jm._colstream_finalize_cap(ref, entries, 8)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[:2] == want[:2] and got[2] is want[2] is None
        caps.append(got)
    # 3 narrow groups hold every "abcd"/"fade" survivor, but the 2 wide
    # groups count alive: 5 exceed half of the 5 groups, so no cap (the
    # presence planes alone would give (3, 2)); the wide-only needles fit
    # the quarter cap of 2 groups
    assert caps[0] is None and caps[1][:2] == (2, 2)


@pytest.mark.parametrize("width,ok", [(4096, False), (1024, True)])
def test_end_col_width_guard(width, ok):
    """A bucket wider than 4095 units would clamp end_col in the 14-bit
    meta field: both packages refuse it; 1024 is served."""
    hay = ["dead" + "x" * 2000 + "beef", "deadbeef"] * 3
    port = pack_corpus(hay, bucket_widths=(width,), device="cpu")
    ref = j_pack(hay, unicode=False, bucket_widths=(width,))
    if ok:
        got = Matcher.from_query("deadbeef").match_arrays(port)
        want = jm.Matcher.from_query("deadbeef").match_arrays(ref)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    with pytest.raises(ValueError, match="end_col"):
        Matcher.from_query("deadbeef").match_arrays(port)
    with pytest.raises(ValueError, match="end_col"):
        match_topk_batch(["deadbeef"], port)
    with pytest.raises(AssertionError, match="end_col"):
        jm.Matcher.from_query("deadbeef").match_arrays(ref)
