"""Mesh-sharded matching in the port against frizbee_tpu.parallel, case by
case as ``tests/test_parallel.py`` pins the reference: the single-query
``match_corpus_sharded`` (ASCII, typo budget, Unicode, greedy rows
rescored, scores of 0x8000 or more) and the Q-query
``match_topk_batch_sharded`` (a fuzzy batch, the full query syntax,
every sort strategy, scores of 0x8000 or more; the greedy and XL cases
are in ``test_torch_parallel_greedy.py``).

Each case runs the port's single-controller mesh on the CPU
(``make_mesh(n, device="cpu")``) at 2, 4 and 8 shards and holds it
three ways: against the reference at the same shard count on JAX's
virtual CPU devices; against the port's own single-device serving
(``match_topk_batch``, ``Matcher.match_arrays``) and the host oracle;
and inside, against the reference on the same inputs — the padded
bucket arrays of ``pad_bucket_for_mesh`` and each bucket's
``sharded_match_topk`` columns, or each shape group's raw (Q, 1 + k, 2)
``sharded_match_sorted_batch`` array. Zero tolerance throughout."""

import numpy as np
import pytest
import torch

import frizbee_tpu.parallel as jp
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.config import UnicodeMatching as JUnicodeMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import FuzzyEngine as JFuzzyEngine
from frizbee_tpu.matcher import Matcher as JMatcher
from frizbee_tpu_torch import (
    Config,
    Matcher,
    Scoring,
    SortStrategy,
    UnicodeMatching,
    datagen,
    match_topk_batch,
    match_topk_batch_sharded,
    pack_corpus,
)
from frizbee_tpu_torch import parallel as tp
from frizbee_tpu_torch.engine import FuzzyEngine

SHARDS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    """(port Config, reference Config) of one option dict, enums and
    scorings by name."""
    tk, jk = dict(kw), dict(kw)
    if "sort" in kw:
        tk["sort"], jk["sort"] = SortStrategy[kw["sort"]], JSortStrategy[
            kw["sort"]]
    if "unicode" in kw:
        tk["unicode"], jk["unicode"] = UnicodeMatching[
            kw["unicode"]], JUnicodeMatching[kw["unicode"]]
    if "scoring" in kw:
        tk["scoring"], jk["scoring"] = Scoring(**kw["scoring"]), JScoring(
            **kw["scoring"])
    return Config(**tk), JConfig(**jk)


def _small():
    return datagen.partial_match_corpus(median_length=20, num_samples=400,
                                        seed=3)


def _unicode_small():
    return datagen.unicode_corpus("arabic", num_samples=300, median_units=16,
                                  needle="إن", needle_every=5, seed=11)


def _greedy_hay():
    return (["linux kernel", "nope", "l" + "ل" * 600 + "inux"]
            + ["لinuلx" + "ل" * 600]
            + ["filler%d" % i for i in range(12)])


def _greedy_xl_hay():
    return (["linux kernel", "nope", "l" + "ل" * 600 + "inux"]
            + ["لinuلx" + "ل" * 600]
            + ["linux" + "x" * 1100]  # XL row (over the widest bucket)
            + ["filler%d" % i for i in range(12)])


def _k_boundary_hay():
    greedy_rows = [
        "l" + "ل" * 600 + "inux",  # window > DP cap: device-capped score
        "لinuلx" + "ل" * 600,
        "li" + "ن" * 700 + "nux",
    ]
    strong = ["%d linux" % i for i in range(6)]  # clean matches
    weak = ["l-i%d-n-u-x" % i for i in range(6)]  # gapped matches
    return strong + greedy_rows + weak + ["filler%d" % i for i in range(20)]


def _wide_hay():
    """Rows whose "deadbeefc" score under a 4000 match score reaches
    0x8000 (a full match: the meta word's sign bit) beside rows one typo
    short of it (below 0x8000) and rows that do not match."""
    forms = ("deadbeefc_%d", "%d/dead-beef-c", "deadbeef_%d", "dxeadbeefc%d",
             "row %d nothing")
    return [forms[i % 5] % i for i in range(160)]


_HAYS = {
    "small": (_small, False),
    "unicode_small": (_unicode_small, True),
    "greedy": (_greedy_hay, True),
    "greedy_xl": (_greedy_xl_hay, True),
    "k_boundary": (_k_boundary_hay, True),
    "wide": (_wide_hay, False),
}
_CORPORA = {}


def _corpora(name):
    """(haystacks, port Corpus on the CPU, reference Corpus), built once
    a module."""
    if name not in _CORPORA:
        make, unicode = _HAYS[name]
        hay = make()
        _CORPORA[name] = (hay, pack_corpus(hay, unicode=unicode,
                                           device="cpu"),
                          j_pack(hay, unicode=unicode))
    return _CORPORA[name]


# -- match_corpus_sharded ----------------------------------------------------

# case: (corpus, needle, config keywords, k)
CORPUS_CASES = {
    "topk": ("small", "deadbeef", {}, 32),
    "typo": ("small", "dead", {"max_typos": 1}, 16),
    "unicode": ("unicode_small", "إن", {}, 24),
    "greedy_rescored": ("greedy", "linux", {}, 16),
    "wide_scores": ("wide", "deadbeefc",
                    {"max_typos": 1, "scoring": {"match_score": 4000}}, 128),
}


def _reference_topk(jcorpus, jengine, jmesh, bucket, k):
    """The reference's sharded_match_topk over one bucket, as numpy."""
    from jax.sharding import PartitionSpec as P

    no_prefilter = jengine.config.max_typos is None
    orig, flip, sc = jengine._device_needle()
    arrs = [jp.put_global_sharded(a, jmesh)
            for a in jp.pad_bucket_for_mesh(bucket, jmesh.devices.size)]
    out = jp.sharded_match_topk(
        *arrs, *(jp.put_global_sharded(np.asarray(a), jmesh, P())
                 for a in (orig, flip, sc)),
        mesh=jmesh, max_typos=0 if no_prefilter else jengine.config.max_typos,
        no_prefilter=no_prefilter, k=k)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(CORPUS_CASES))
def test_match_corpus_sharded(case, n):
    name, needle, kw, k = CORPUS_CASES[case]
    hay, corpus, jcorpus = _corpora(name)
    cfg, jcfg = _cfgs(**kw)
    mesh, jmesh = tp.make_mesh(n, device="cpu"), jp.make_mesh(n)
    engine, jengine = FuzzyEngine(needle, cfg), JFuzzyEngine(needle, jcfg)

    # each bucket's padded arrays and sharded top-k columns
    for b, jb in zip(corpus.buckets, jcorpus.buckets):
        for x, y in zip(tp.pad_bucket_for_mesh(b, n),
                        jp.pad_bucket_for_mesh(jb, n)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        got = [x.numpy() for x in tp.sharded_match_topk(
            *tp.pad_bucket_for_mesh(b, n),
            *engine._device_needle("cpu"),
            mesh=mesh, max_typos=int(cfg.max_typos or 0),
            no_prefilter=cfg.max_typos is None, k=k)]
        want = _reference_topk(jcorpus, jengine, jmesh, jb, k)
        matched = want[0]
        np.testing.assert_array_equal(got[0], matched)
        np.testing.assert_array_equal(got[1], want[1])  # index (or PAD)
        # unmatched entries tie on the key; their payloads are unordered
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g[matched], np.asarray(w)[matched])

    got = tp.match_corpus_sharded(corpus, engine, mesh, k=k)
    want = jp.match_corpus_sharded(jcorpus, jengine, jmesh, k=k)
    single = Matcher(needle, cfg).match_arrays(corpus)
    oracle = Matcher(needle, cfg, use_device=False).match_arrays(hay)
    assert len(got[0]) == min(k, len(oracle[0])) > 0
    for g, w, s, o in zip(got, want, single, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s[:k])
        np.testing.assert_array_equal(g, o[:k])
    if case == "wide_scores":
        assert got[1].max() >= 0x8000 > got[1].min()


# -- match_topk_batch_sharded ------------------------------------------------


def _full_syntax(cfg_cls, matcher_cls):
    cfg = cfg_cls(max_typos=1)
    return [
        matcher_cls("dead", cfg),
        matcher_cls.from_query("dead !beef", cfg),  # negation veto
        matcher_cls.from_query("'dead", cfg),  # literal substring
        matcher_cls.from_query("^dead", cfg),  # literal prefix
        matcher_cls.from_query("beef$", cfg),  # literal suffix
        matcher_cls.from_query("dead beef", cfg),  # multi-pattern sum
        matcher_cls("dead", cfg_cls(max_typos=2)),
        matcher_cls("", cfg),  # empty: host copy path
    ]


# case: (corpus, queries (strings, or "full_syntax"), config keywords, k);
# the greedy cases are in test_torch_parallel_greedy.py
BATCH_CASES = {
    "batch_topk": ("small", ["deadbeef", "dead", "beef", "zqzqzq"], {}, 16),
    "full_syntax": ("small", "full_syntax", {"max_typos": 1}, 12),
    **{f"sort_{s.name.lower()}": ("small", ["dead", "beef"],
                                  {"sort": s.name}, 10)
       for s in SortStrategy},
    "wide_scores": ("wide", ["deadbeefc", "dead"],
                    {"max_typos": 1, "scoring": {"match_score": 4000}}, 128),
}


def _assert_topk_equal(got, want):
    assert len(got) == len(want)
    for (gc, gi, gs, ge, gec), (wc, wi, ws, we, wec) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))
        np.testing.assert_array_equal(np.asarray(ge, bool),
                                      np.asarray(we, bool))
        np.testing.assert_array_equal(np.asarray(gec), np.asarray(wec))


def _spy(monkeypatch, module, calls):
    """Record every shape group's raw sharded array."""
    orig = module.sharded_match_sorted_batch

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append(np.array(out.numpy() if torch.is_tensor(out) else out))
        return out

    monkeypatch.setattr(module, "sharded_match_sorted_batch", spy)


def check_batch_sharded(name, queries, kw, k, n, monkeypatch, sharded=True):
    """One batch case at ``n`` shards: each shape group's raw array
    (none when ``sharded`` is false: every query takes the single-device
    path) and the decoded top-k against the reference's, and the top-k
    against the port's single-device ``match_topk_batch``."""
    _hay, corpus, jcorpus = _corpora(name)
    cfg, jcfg = _cfgs(**kw)
    if queries == "full_syntax":
        tq, jq = _full_syntax(Config, Matcher), _full_syntax(JConfig,
                                                             JMatcher)
    else:
        tq = jq = queries
    raw, jraw = [], []
    _spy(monkeypatch, tp, raw)
    _spy(monkeypatch, jp, jraw)
    got = match_topk_batch_sharded(tq, corpus, tp.make_mesh(n, device="cpu"),
                                   cfg, k=k)
    want = jp.match_topk_batch_sharded(jq, jcorpus, jp.make_mesh(n), jcfg,
                                       k=k)
    assert len(raw) == len(jraw) and bool(raw) == sharded
    for g, w in zip(raw, jraw):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    _assert_topk_equal(got, want)
    _assert_topk_equal(got, match_topk_batch(tq, corpus, cfg, k=k))
    assert sum(r[0] for r in got) > 0
    return got


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_match_topk_batch_sharded(case, n, monkeypatch):
    got = check_batch_sharded(*BATCH_CASES[case], n, monkeypatch)
    if case == "wide_scores":
        assert got[0][2].max() >= 0x8000 > got[0][2].min()


def test_mesh_construction():
    """A CPU mesh holds its shards on the one device; with no device the
    mesh is the card's and raises here, where there is none (it never
    drifts to the CPU); a corpus of strings packs on the mesh's device;
    the feed takes each shard's rows."""
    mesh = tp.make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.group is None
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert tp.make_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.make_mesh(2)
    # a corpus given as strings is packed on the mesh's device
    hay = ["deadbeef", "x", "dxexaxd"]
    _assert_topk_equal(
        match_topk_batch_sharded(["dead"], hay, tp.make_mesh(2, device="cpu"),
                                 Config(), k=4),
        match_topk_batch(["dead"], pack_corpus(hay, device="cpu"), Config(),
                         k=4))
    rows = np.arange(12, dtype=np.int32).reshape(6, 2)
    parts = tp.put_global_sharded(rows, tp.make_mesh(3, device="cpu"))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    with pytest.raises(ValueError):
        tp.put_global_sharded(rows, mesh)


def test_shard_views_are_views():
    """Inside the bucket a shard's rows are views of the bucket's
    tensors; the shard that runs past it is padded with rows that can
    never match (index -1, zero units, previous byte -1, no presence)."""
    _hay, corpus, _j = _corpora("small")
    b = corpus.buckets[0]
    n = 3
    shards = tp._mesh_pad_buckets(corpus, tp.make_mesh(n, device="cpu"))
    chunk = -(-b.size // n)
    assert chunk * n > b.size  # the last shard holds padding
    full = b.device_arrays()
    cp0 = shards[0][0].device_arrays()[0]
    assert cp0.data_ptr() == full[0].data_ptr()
    last = shards[-1][0]
    pad = chunk * n - b.size
    cp, _fb, plb, _bo, _bl, nu, _nb, idx = last.device_arrays()
    assert (idx[-pad:] == -1).all() and (nu[-pad:] == 0).all()
    assert (plb[-pad:] == -1).all() and (cp[-pad:] == 0).all()
    torch.testing.assert_close(
        torch.cat([s[0].device_arrays_rowmajor()[2] for s in shards])[
            :b.size], b.device_arrays_rowmajor()[2], rtol=0, atol=0)
    assert (last.device_presence_bits()[-pad:] == 0).all()


@pytest.mark.parametrize("name", ["small", "unicode_small"])
def test_shard_views_from_host_rows(name):
    """Views built from a shard's host rows (a process group's, or a
    shard on another device) equal the views of the bucket's device
    tensors, padding included; the views are kept on the corpus, one
    set a mesh layout."""
    _hay, corpus, _j = _corpora(name)
    mesh = tp.make_mesh(3, device="cpu")
    shards = tp._mesh_pad_buckets(corpus, mesh)
    assert tp._mesh_pad_buckets(corpus, mesh) is shards
    assert tp._mesh_pad_buckets(corpus, tp.make_mesh(3, device="cpu")) \
        is shards
    assert tp._mesh_pad_buckets(corpus, tp.make_mesh(2, device="cpu")) \
        is not shards
    for views in shards:
        for v in views:
            assert not v.from_host
            h = tp.ShardView(v.bucket, v.lo, v.hi, v.device, from_host=True)
            for got, want in ((h.device_arrays(), v.device_arrays()),
                              (h.device_arrays_rowmajor(),
                               v.device_arrays_rowmajor()),
                              ((h.device_presence_bits(),),
                               (v.device_presence_bits(),))):
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    assert torch.equal(g, w)
