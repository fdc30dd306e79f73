"""The generic literal pipelines of the port against frizbee_tpu's:
``literal_pipeline`` over ``PackedBucket.device_arrays`` in all four
modes, in bytes and in codepoints, needles longer than the bucket width
included; the kernels' row adapters ``literal_pipeline_ascii`` and
``literal_pipeline_units``; ``_fused_literal_batch_fast`` (single literal
needles over 16 units) through both packages' batch dispatchers, with
``SORT_BODY_BUDGET`` lowered in both for the per-query sort; and the
``LiteralEngine``'s device ``match_corpus`` against the reference's and
its host oracle.

Inputs are made from a seed and handed to both packages; every output is
an integer or a bool, compared with zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu.ops.literal as jliteral
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
import frizbee_tpu_torch.ops.literal as tliteral
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Matching as JMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import make_engine as j_make_engine
from frizbee_tpu_torch import Config, datagen
from frizbee_tpu_torch.config import Matching
from frizbee_tpu_torch.corpus import pack_corpus
from frizbee_tpu_torch.engine import make_engine
from frizbee_tpu_torch.oracle import make_needle_units

SCORING = (12, 6, 5, 1, 12, 4, 4, 8, 4)
MODES = ["exact", "prefix", "suffix", "substring"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ascii_hay():
    hay = datagen.partial_match_corpus(median_length=20, num_samples=300,
                                       seed=14)
    hay += ["deadbeef", "DeadBeef", "xx_deadbeef", "deadbeef/deadbeef",
            "deadbeefdeadbeefdeadbeef", "Dead-Beef-dead"]
    return hay


def _unicode_hay():
    hay = datagen.unicode_corpus("arabic", num_samples=250, needle="إن",
                                 needle_every=5, seed=15)
    return hay + ["إن", "Aإن_إن", "إنإنإنإن", "xإن", "إن" * 10]


@pytest.fixture(scope="module")
def corpora():
    a, u = _ascii_hay(), _unicode_hay()
    return {
        False: (a, pack_corpus(a, device="cpu"), j_pack(a, unicode=False)),
        True: (u, pack_corpus(u, unicode=True, device="cpu"),
               j_pack(u, unicode=True)),
    }


def _eq(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want))


def _needle(text, unicode):
    u = make_needle_units(text, unicode, False)
    return np.array(u.orig, np.int32), np.array(u.flip, np.int32)


NEEDLES = {False: ["deadbeef", "dead", "d", "deadbeefdeadbeefdeadbeefdeadbeefx"],
           True: ["إن", "إنإن", "ن", "إن" * 20]}


@pytest.mark.parametrize("unicode", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_literal_pipeline(corpora, unicode, mode):
    """literal_pipeline over the 8-tuple, and the kernels' row adapters,
    per bucket and needle (the last needle is wider than every bucket
    it meets)."""
    _hay, port, ref = corpora[unicode]
    for text in NEEDLES[unicode]:
        o, f = _needle(text, unicode)
        nbl = len(text.encode("utf-8"))
        for pb, rb in zip(port.buckets, ref.buckets):
            got = tliteral.literal_pipeline(
                *pb.device_arrays()[:7], torch.from_numpy(o),
                torch.from_numpy(f), None, mode=mode, needle_byte_len=nbl,
                scoring=SCORING)
            want = jliteral.literal_match_bucket(
                *rb.device_arrays()[:7], jnp.asarray(o), jnp.asarray(f),
                jnp.asarray(np.array(SCORING, np.int32)), mode=mode,
                needle_byte_len=nbl, scoring=SCORING)
            for g, w in zip(got, want):
                _eq(g, w)
            cp, nu, _idx = pb.device_arrays_rowmajor()
            rarr = (rb.device_arrays_units() if unicode
                    else rb.device_arrays_ascii())
            adapt = (tliteral.literal_pipeline_units if unicode
                     else tliteral.literal_pipeline_ascii)
            jadapt = (jliteral.literal_pipeline_units if unicode
                      else jliteral.literal_pipeline_ascii)
            got = adapt(cp, nu[:, None], torch.from_numpy(o),
                        torch.from_numpy(f), None, mode=mode,
                        needle_byte_len=nbl, scoring=SCORING)
            want = jadapt(rarr[0], rarr[1], jnp.asarray(o), jnp.asarray(f),
                          None, mode=mode, needle_byte_len=nbl,
                          scoring=SCORING)
            for g, w in zip(got, want):
                _eq(g, w)


def _dispatch_both(corpora, queries, k, groups=1, **cfg):
    """Raw (Q, 1 + k, 2) arrays of both dispatchers, group by group;
    asserts each group took the literal fast path."""
    hay, port, ref = corpora
    before = dict(tbatch.GENERIC_ROUTES)
    tcfg = Config(**{key: Matching[v.name] if key == "matching" else v
                     for key, v in cfg.items()})
    jcfg = JConfig(**cfg)
    pending = tm._dispatch_batch_groups(
        [tm.Matcher.from_query(q, tcfg) for q in queries], port, tcfg, k)
    jpending, _ = jm._dispatch_batch_groups(
        [jm.Matcher.from_query(q, jcfg) for q in queries], ref, jcfg, k)
    assert len(pending) == len(jpending) == groups
    for (got, _r, members), (want, jmembers) in zip(pending, jpending):
        assert members == jmembers
        _eq(got, want)
    assert (tbatch.GENERIC_ROUTES["literal_fast"]
            == before["literal_fast"] + groups)
    return np.concatenate([p[0].numpy() for p in pending])


def _long_prefixes(hay, count, lo=17, seed=0):
    """``^`` prefixes of ``lo`` bytes cut from seeded sampled rows."""
    rng = np.random.default_rng(seed)
    rows = [h for h in hay if len(h) >= lo]
    picks = rng.choice(len(rows), count, replace=False)
    return ["^" + rows[i][:lo] for i in picks]


@pytest.mark.parametrize("in_body", [False, True])
def test_literal_fast_bytes(corpora, monkeypatch, in_body):
    """Pasted path prefixes of 17-23 bytes (and one no row holds): the
    batched sort, and one sort a query past the lowered budget."""
    if in_body:
        monkeypatch.setattr(jbatch, "SORT_BODY_BUDGET", 1 << 10)
        monkeypatch.setattr(tbatch, "SORT_BODY_BUDGET", 1 << 10)
    hay = corpora[False][0]
    queries = [q[:19] for q in _long_prefixes(hay, 3, lo=18, seed=1)]
    queries += ["^zzzzzzzzzzzzzzzzzz"]
    out = _dispatch_both(corpora[False], queries, 40)
    assert out[0, 0, 0] >= 1 and out[-1, 0, 0] == 0


@pytest.mark.parametrize("mode", ["exact", "suffix", "substring"])
def test_literal_fast_modes(corpora, mode):
    """The other modes over 17-byte needles, in bytes."""
    out = _dispatch_both(corpora[False],
                         ["deadbeefdeadbeefd", "eadbeefdeadbeefde"], 30,
                         matching=getattr(JMatching, mode.upper()))
    assert out.shape == (2, 31, 2)


def test_literal_fast_codepoints(corpora):
    """A codepoint literal of 17+ units over the Arabic corpus."""
    out = _dispatch_both(corpora[True], ["^" + "إن" * 9, "'" + "إن" * 9],
                         30, groups=2)
    assert out[1, 0, 0] >= 1


@pytest.mark.parametrize("unicode", [False, True])
@pytest.mark.parametrize("mode", ["prefix", "substring"])
def test_literal_engine_device(unicode, mode):
    """LiteralEngine.match_corpus on the device over a corpus with XL
    rows: the buckets on the corpus device, the XL rows on the host; the
    same as the reference's engine and its host oracle."""
    hay = (_unicode_hay() if unicode else _ascii_hay())[:120]
    hay = hay + [("إن" if unicode else "dead") + "x" * 1500]
    needle = "إن" if unicode else "dead"
    tcfg = Config(matching=Matching[mode.upper()])
    jcfg = JConfig(matching=getattr(JMatching, mode.upper()))
    eng = make_engine(needle, tcfg, use_device=True)
    assert eng.unicode == unicode
    port = pack_corpus(hay, unicode=unicode, device="cpu")
    ref = j_pack(hay, unicode=unicode)
    assert len(port.xl_indices) == 1
    got = eng.match_corpus(port)
    for use_device in (True, False):
        want = j_make_engine(needle, jcfg, use_device).match_corpus(ref)
        for f in ("matched", "score", "exact", "end_col"):
            _eq(getattr(got, f), getattr(want, f))
    assert got.matched[-1]
