"""The generic fuzzy pipelines of the port against frizbee_tpu's, module by
module: ``PackedBucket.device_arrays`` and ``Corpus.device_xl_mask``, the
stage-1 presence forms (``presence_mask``, ``presence_bits``,
``stage1_presence``), ``ops/fuzzy``'s ``prefilter_bucket``,
``sw_score_bucket`` and ``fuzzy_pipeline`` (needles longer than the
bucket width, needles no longer than the budget, ``no_prefilter`` and
greedy rows of a width-2048 bucket), ``kernels.fuzzy_match_units`` (with
and without stage 1, byte rows in int32 and int16 lanes, codepoint
rows; the reference in Pallas interpret mode), ``batch._select_sorted``
under both keys, ``batch.order_keys``, ``fuzzy.scoring_vector`` and
``fused_match_sorted``'s whole (1 + rows, 2) output.

Inputs are made from a seed and handed to both packages; every output
is an integer or a bool, compared with zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu.ops.fuzzy as jfuzzy
import frizbee_tpu.ops.kernels as jkernels
import frizbee_tpu.ops.presence as jpresence
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
import frizbee_tpu_torch.ops.fuzzy as tfuzzy
import frizbee_tpu_torch.ops.kernels as tkernels
import frizbee_tpu_torch.ops.presence as tpresence
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu_torch import Config, Scoring, SortStrategy, datagen
from frizbee_tpu_torch.corpus import pack_corpus
from frizbee_tpu_torch.oracle import make_needle_units

DEFAULT_SCORING = tuple(int(v) for v in tkernels.DEFAULT_SCORING)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _hay(seed=5, n=300, median=20):
    rng = np.random.default_rng(seed)
    hay = datagen.partial_match_corpus(median_length=median, num_samples=n,
                                       seed=seed)
    # a few case and delimiter contexts, and rows of every bucket class
    hay += ["Dead_Beef/" + h for h in hay[:20]]
    hay += ["".join(rng.choice(list("deabf_/-XY"), int(k)))
            for k in rng.integers(30, 90, 40)]
    return hay


def _unicode_hay(seed=6):
    hay = datagen.unicode_corpus("arabic", num_samples=300, needle="إن",
                                 needle_every=7, seed=seed)
    return hay + ["إن Abc_" + h for h in hay[:20]]


@pytest.fixture(scope="module")
def ascii_corpora():
    hay = _hay()
    return hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)


@pytest.fixture(scope="module")
def unicode_corpora():
    hay = _unicode_hay()
    return (hay, pack_corpus(hay, unicode=True, device="cpu"),
            j_pack(hay, unicode=True))


def _eq(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want))


def _needle(text, unicode, case_sensitive=False):
    u = make_needle_units(text, unicode, case_sensitive)
    return (np.array(u.orig, np.int32), np.array(u.flip, np.int32))


@pytest.mark.parametrize("kind", ["ascii", "unicode", "widths"])
def test_device_arrays(kind, ascii_corpora, unicode_corpora):
    """The generic pipelines' 8-tuple equals the reference's element for
    element, and so does the XL mask."""
    if kind == "ascii":
        hay, port, ref = ascii_corpora
    elif kind == "unicode":
        hay, port, ref = unicode_corpora
    else:
        hay = _hay(seed=8, n=200) + ["x" * 3000]
        port = pack_corpus(hay, bucket_widths=(48, 2048), device="cpu")
        ref = j_pack(hay, unicode=False, bucket_widths=(48, 2048))
    assert len(port.buckets) == len(ref.buckets) > 0
    for pb, rb in zip(port.buckets, ref.buckets):
        got, want = pb.device_arrays(), rb.device_arrays()
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            _eq(g, w)
        assert pb.device_arrays()[0] is got[0]  # cached
    _eq(port.device_xl_mask(), ref.device_xl_mask())


@pytest.mark.parametrize("kind", ["ascii", "unicode"])
def test_presence_forms(kind, ascii_corpora, unicode_corpora):
    """presence_mask, presence_bits (also equal to the resident planes)
    and stage1_presence over several budgets."""
    _hay_, port, ref = ascii_corpora if kind == "ascii" else unicode_corpora
    needles = (["deadbeef", "Dab", "zzq", "feed"] if kind == "ascii"
               else ["إن", "إنما", "Abc", "ءءء"])
    for pb, rb in zip(port.buckets, ref.buckets):
        cp = torch.from_numpy(np.ascontiguousarray(pb.cp))
        nu = torch.from_numpy(pb.n_units)
        mask = tpresence.presence_mask(cp, nu)
        jmask = jpresence.presence_mask(jnp.asarray(rb.cp),
                                        jnp.asarray(rb.n_units)[:, None])
        _eq(mask, jmask)
        bits = tpresence.presence_bits(mask)
        _eq(bits, jpresence.presence_bits(jmask))
        _eq(bits, pb.device_presence_bits())
        for text in needles:
            o, f = _needle(text, kind == "unicode")
            packed = np.concatenate([o, f])
            for t in (0, 1, 2):
                _eq(tpresence.stage1_presence(mask, torch.from_numpy(packed),
                                              t),
                    jpresence.stage1_presence(jmask, jnp.asarray(packed), t))


# (needle, max_typos, no_prefilter): typo budgets 0-2, a needle no longer
# than its budget, unconditional scoring, and a needle longer than the
# narrow buckets' width
PIPELINE_CASES = [
    ("deadbeef", 0, False),
    ("dEadbf", 1, False),
    ("dab", 2, False),
    ("de", 3, False),
    ("beef", 0, True),
    ("deadbeefdeadbeefdeadbeefx", 1, False),
]


@pytest.mark.parametrize("needle,typos,nopre", PIPELINE_CASES)
def test_fuzzy_pipeline_bytes(ascii_corpora, needle, typos, nopre):
    """prefilter_bucket, sw_score_bucket and fuzzy_pipeline per bucket,
    each output against the reference's."""
    _hay_, port, ref = ascii_corpora
    o, f = _needle(needle, False)
    sc = np.array(DEFAULT_SCORING, np.int32)
    for pb, rb in zip(port.buckets, ref.buckets):
        got_a, want_a = pb.device_arrays(), rb.device_arrays()
        cp, fb, plb, boff, blen, nu, nb, _idx = got_a
        jcp, jfb, jplb, jboff, jblen, jnu, jnb, _jidx = want_a
        if not nopre:
            pre = tfuzzy.prefilter_bucket(cp, boff, blen, nu, nb,
                                          torch.from_numpy(o),
                                          torch.from_numpy(f), typos)
            jpre = jfuzzy.prefilter_bucket(jcp, jboff, jblen, jnu, jnb,
                                           jnp.asarray(o), jnp.asarray(f),
                                           typos)
            for g, w in zip(pre, jpre):
                _eq(g, w)
        got = tfuzzy.fuzzy_pipeline(*got_a[:7], torch.from_numpy(o),
                                    torch.from_numpy(f),
                                    torch.from_numpy(sc), max_typos=typos,
                                    no_prefilter=nopre)
        want = jfuzzy.fuzzy_match_bucket(*want_a[:7], jnp.asarray(o),
                                         jnp.asarray(f), jnp.asarray(sc),
                                         max_typos=typos,
                                         no_prefilter=nopre)
        for g, w in zip(got, want):
            _eq(g, w)
        ws, we = got[5], got[6]
        _eq(tfuzzy.sw_score_bucket(cp, fb, plb, boff, blen, nu, ws, we,
                                   torch.from_numpy(o), torch.from_numpy(f),
                                   torch.from_numpy(sc)),
            np.stack([np.asarray(x) for x in jfuzzy.sw_score_bucket(
                jcp, jfb, jplb, jboff, jblen, jnu, jnp.asarray(ws.numpy()),
                jnp.asarray(we.numpy()), jnp.asarray(o), jnp.asarray(f),
                jnp.asarray(sc))]))


@pytest.mark.parametrize("needle,typos", [("إن", 0), ("إنAb", 1)])
def test_fuzzy_pipeline_codepoints(unicode_corpora, needle, typos):
    _hay_, port, ref = unicode_corpora
    o, f = _needle(needle, True)
    sc = np.array(DEFAULT_SCORING, np.int32)
    for pb, rb in zip(port.buckets, ref.buckets):
        got = tfuzzy.fuzzy_pipeline(
            *pb.device_arrays()[:7], torch.from_numpy(o),
            torch.from_numpy(f), torch.from_numpy(sc), max_typos=typos)
        want = jfuzzy.fuzzy_match_bucket(
            *rb.device_arrays()[:7], jnp.asarray(o), jnp.asarray(f),
            jnp.asarray(sc), max_typos=typos, no_prefilter=False)
        for g, w in zip(got, want):
            _eq(g, w)


def test_fuzzy_pipeline_greedy_rows():
    """Rows whose trimmed window passes the DP cap in a width-2048 bucket
    are flagged greedy, with the rest of the row's outputs equal."""
    rng = np.random.default_rng(12)
    hay = ["d" + "".join(rng.choice(list("xyz"), int(k))) + "ead"
           for k in rng.integers(1100, 1900, 12)]
    hay += ["dead" + "x" * int(k) for k in rng.integers(1100, 1900, 6)]
    port = pack_corpus(hay, bucket_widths=(2048,), device="cpu")
    ref = j_pack(hay, unicode=False, bucket_widths=(2048,))
    o, f = _needle("dead", False)
    sc = np.array(DEFAULT_SCORING, np.int32)
    greedy = 0
    for pb, rb in zip(port.buckets, ref.buckets):
        got = tfuzzy.fuzzy_pipeline(
            *pb.device_arrays()[:7], torch.from_numpy(o),
            torch.from_numpy(f), torch.from_numpy(sc), max_typos=0)
        want = jfuzzy.fuzzy_match_bucket(
            *rb.device_arrays()[:7], jnp.asarray(o), jnp.asarray(f),
            jnp.asarray(sc), max_typos=0, no_prefilter=False)
        for g, w in zip(got, want):
            _eq(g, w)
        greedy += int(got[4].sum())
    assert greedy >= 12


def _fmu_case(corpora, needle, unicode, typos, nopre, scoring, stage1):
    _hay_, port, ref = corpora
    o, f = _needle(needle, unicode)
    packed = np.concatenate([o, f])
    for pb, rb in zip(port.buckets, ref.buckets):
        cp, nu, _idx = pb.device_arrays_rowmajor()
        rarr = (rb.device_arrays_units() if unicode
                else rb.device_arrays_ascii())
        # the reference's per-row stage 1 (its mask4 form)
        s1 = (tpresence.stage1_presence(tpresence.presence_mask(cp, nu),
                                        torch.from_numpy(packed),
                                        min(typos, len(o)))
              if stage1 else None)
        got = tkernels.fuzzy_match_units(
            cp, nu, torch.from_numpy(packed), max_typos=typos,
            no_prefilter=nopre, scoring=scoring, survivors=s1)
        want = jkernels.fuzzy_match_units(
            rarr[0], rarr[1], jnp.asarray(packed), max_typos=typos,
            no_prefilter=nopre, scoring=scoring, unicode=unicode,
            mask4=rarr[3] if stage1 else None)
        for g, w in zip(got, want):
            _eq(g, w)
        # the batch flows' survivor form: the capped-count matmul
        if stage1 and not nopre:
            need, tot = tpresence.needle_need_matrix(
                torch.from_numpy(packed)[None])
            s1 = (tpresence.presence_hits(pb.device_presence_bits(), need)
                  >= (tot - min(typos, len(o)))[None, :]).T
            got2 = tkernels.fuzzy_match_units(
                cp, nu, torch.from_numpy(packed)[None], max_typos=typos,
                no_prefilter=nopre, scoring=scoring, survivors=s1)
            for g, w in zip(got2, want):
                _eq(g[0], w)


@pytest.mark.parametrize("needle,typos,nopre,stage1,wide", [
    ("deadbeef", 0, False, True, False),   # int16 lanes, stage 1
    ("deadbeef", 1, False, False, False),  # int16 lanes, no stage 1
    ("dEadbf", 2, False, True, True),      # int32 lanes (wide scoring)
    ("beef", 0, True, True, False),        # unconditional: no stage 1
])
def test_fuzzy_match_units_bytes(ascii_corpora, needle, typos, nopre, stage1,
                                 wide):
    scoring = ((6000,) + DEFAULT_SCORING[1:]) if wide else DEFAULT_SCORING
    W = max(b.width for b in ascii_corpora[1].buckets)
    assert tkernels.int16_lanes_dispatch(
        "cpu", False, scoring, len(needle), W) != wide
    _fmu_case(ascii_corpora, needle, False, typos, nopre, scoring, stage1)


@pytest.mark.parametrize("needle,typos,stage1", [("إن", 0, True),
                                                 ("إنAb", 1, False)])
def test_fuzzy_match_units_codepoints(unicode_corpora, needle, typos,
                                      stage1):
    _fmu_case(unicode_corpora, needle, True, typos, False, DEFAULT_SCORING,
              stage1)


def test_fuzzy_match_units_reference_stage1():
    """A width-1024 bucket of 640 rows: the reference applies its stage 1
    too (B >= 2 blocks), so both packages reject before the kernel."""
    rng = np.random.default_rng(3)
    hay = ["".join(rng.choice(list("deabfxyz_"), int(k)))
           for k in rng.integers(520, 1000, 640)]
    corpora = (hay, pack_corpus(hay, device="cpu"), j_pack(hay, False))
    assert [b.width for b in corpora[1].buckets] == [1024]
    _fmu_case(corpora, "deadbeefdab", False, 1, False, DEFAULT_SCORING,
              True)


@pytest.mark.parametrize("sort_by_score", [True, False])
def test_select_sorted(sort_by_score):
    """Both keys over random columns, scores of 0x8000 and above and
    padding rows included, sentinel rows decoded past the count."""
    rng = np.random.default_rng(9 + sort_by_score)
    B, n = 700, 5000
    matched = rng.random(B) < 0.4
    score = rng.integers(0, 0x10000, B).astype(np.int32)
    score[:20] = 0xFFFF
    exact = rng.random(B) < 0.2
    greedy = rng.random(B) < 0.1
    end_col = rng.integers(0, 0x5000, B).astype(np.int32)
    index = rng.permutation(n)[:B].astype(np.int32)
    index[-30:] = -1
    matched[-30:] = False
    cnt, rows = tbatch._select_sorted(
        *(torch.from_numpy(a) for a in (matched, score, exact, end_col,
                                        greedy, index)),
        n, None, sort_by_score)
    jcnt, jrows = jbatch._select_sorted(
        *(jnp.asarray(a) for a in (matched, score, exact, end_col, greedy,
                                   index)),
        n, None, sort_by_score)
    assert int(cnt) == int(jcnt) == int(matched.sum())
    _eq(rows, jrows)
    # batched over queries: each row of the batch equals its own call
    cols = [torch.from_numpy(np.stack([a, a[::-1].copy()]))
            for a in (matched, score, exact, end_col, greedy, index)]
    bcnt, brows = tbatch._select_sorted(*cols, n, None, sort_by_score)
    assert int(bcnt[0]) == int(cnt)
    _eq(brows[0], rows)


@pytest.mark.parametrize("query,cfg", [
    ("dead", {"sort": "INDEX_ASC"}),
    ("deadbeef", {"sort": "INDEX_DESC", "max_typos": 1}),
    ("deadbeefdeadbeefdeadbeefdeadbeefdeadbeefdeadbeefdeadbeefdeadbeefd",
     {}),
    ("deadbeefda", {"max_typos": 9}),
])
def test_fused_match_sorted_output(ascii_corpora, query, cfg):
    """The generic one-query program's whole (1 + rows, 2) output, rows
    past the count included, through both Matchers' ``_fused_dispatch``;
    with ``use_kernel`` (index sorts) and without (a needle over 64
    units, a budget over 8)."""
    _hay_, port, ref = ascii_corpora
    tcfg = Config(**{k: SortStrategy[v] if k == "sort" else v
                     for k, v in cfg.items()})
    jcfg = JConfig(**{k: JSortStrategy[v] if k == "sort" else v
                      for k, v in cfg.items()})
    before = dict(tbatch.GENERIC_ROUTES)
    _c, out, host, _ready = tm.Matcher.from_query(query, tcfg) \
        ._fused_dispatch(port)
    _jc, jout, _jhead = jm.Matcher.from_query(query, jcfg) \
        ._fused_dispatch(ref)
    _eq(out, jout)
    route = "kernel_body" if "sort" in cfg else "pipeline_body"
    assert tbatch.GENERIC_ROUTES[route] == before[route] + 1
    assert out.shape[0] == 1 + sum(b.size for b in port.buckets)


def test_wide_scoring_select_above_0x8000(ascii_corpora):
    """A scoring whose combined scores pass 0x8000 under an index sort:
    the meta word rides the int32 sign bit on both sides."""
    _hay_, port, ref = ascii_corpora
    big = dict(match_score=5000)
    tcfg = Config(scoring=Scoring(**big), sort=SortStrategy.INDEX_ASC)
    jcfg = JConfig(scoring=JScoring(**big), sort=JSortStrategy.INDEX_ASC)
    got = tm.Matcher.from_query("deadbeef", tcfg)._fused_dispatch(port)[1]
    want = jm.Matcher.from_query("deadbeef", jcfg)._fused_dispatch(ref)[1]
    _eq(got, want)
    count = int(got[0, 0])
    assert count > 0 and (got[1:1 + count, 1] < 0).any()


def test_order_keys_and_scoring_vector():
    """The shared (matched, score desc, index asc) sort keys, and the
    scoring vector of a non-default Scoring."""
    rng = np.random.default_rng(17)
    matched = rng.random(400) < 0.5
    score = rng.integers(0, 0x10000, 400).astype(np.int32)
    index = rng.permutation(400).astype(np.int32)
    got = tbatch.order_keys(*(torch.from_numpy(a)
                              for a in (matched, score, index)))
    want = jbatch.order_keys(*(jnp.asarray(a)
                               for a in (matched, score, index)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)
    kw = dict(match_score=20, gap_open_penalty=7, delimiter_bonus=3)
    _eq(tfuzzy.scoring_vector(Scoring(**kw)),
        jfuzzy.scoring_vector(JScoring(**kw)))
