"""The port's host side against frizbee_tpu: the oracle copies
(``frizbee_tpu_torch/oracle/``) against ``frizbee_tpu.oracle`` on seeded
rows, byte and unicode; ``Corpus.xl_presence`` and the matcher's XL
presence gate; the engines' host pipelines; and served top-k over
corpora with XL rows (wider than the widest bucket) and greedy-flagged
rows (trimmed window over the 1024-byte DP cap), single-pattern,
multi-pattern and negated, including a corpus saved by frizbee_tpu and
read back through ``Corpus.load``.

Inputs are made from a seed and handed to both packages; every
comparison has zero tolerance."""

import random

import numpy as np
import pytest
import torch

import frizbee_tpu.oracle as jo
import frizbee_tpu_torch.oracle as to
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Matching as JMatching
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.config import UnicodeMatching as JUnicodeMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import make_engine as j_engine
from frizbee_tpu.matcher import Matcher as JMatcher
from frizbee_tpu.matcher import match_topk_batch as j_topk
from frizbee_tpu.oracle.smith_waterman import match_end_col as j_end_col
from frizbee_tpu.oracle.smith_waterman import sw_matrices as j_sw_matrices
from frizbee_tpu_torch import (
    Config,
    Corpus,
    Matcher,
    UnicodeMatching,
    match_topk_batch,
    pack_corpus,
)
from frizbee_tpu_torch.config import Matching, Scoring
from frizbee_tpu_torch.engine import make_engine
from frizbee_tpu_torch.oracle.smith_waterman import match_end_col, sw_matrices

ALPHA = "abcdeABC_/. 01xyz"
ARABIC = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي إن"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rows(rng, n, alpha, lo=0, hi=60):
    return [
        "".join(rng.choice(alpha) for _ in range(rng.randint(lo, hi)))
        for _ in range(n)
    ]


def _xl_rows(rng, n):
    """Rows past the widest bucket, half embedding "linux" spread out
    (the reference's tests/test_host_match_batch.py generator)."""
    out = []
    for i in range(n):
        body = "".join(
            rng.choice(ALPHA) for _ in range(rng.randint(1100, 3000))
        )
        if i % 2 == 0:
            body = "l" + body + "inux" if i % 4 == 0 else "li" + body + "nux"
        out.append(body)
    return out


def _jcfg(cfg):
    out = {}
    for key, v in cfg.items():
        if key == "unicode":
            v = JUnicodeMatching[v.name]
        elif key == "matching":
            v = JMatching[v.name]
        out[key] = v
    return JConfig(**out)


@pytest.mark.parametrize("unicode", [False, True])
def test_oracle_copies_match_reference(unicode):
    """prefilter_window, the SW score and end column, match_greedy and
    literal_find (every mode) on seeded rows, byte and unicode units."""
    rng = random.Random(3 + unicode)
    alpha = ARABIC + "ab" if unicode else ALPHA
    rows = _rows(rng, 120, alpha, 0, 40) + _rows(rng, 4, alpha, 300, 700)
    needles = ["ab", "a0x", "إن", "ن ب"] if unicode else [
        "ab", "a0x", "ABC", "x_y", "e"]
    scoring, jscoring = Scoring(), JScoring()
    for needle in needles:
        for cs in (False, True):
            tu = to.make_needle_units(needle, unicode, cs)
            ju = jo.make_needle_units(needle, unicode, cs)
            assert (tu.orig, tu.flip) == (ju.orig, ju.flip)
            for h in rows:
                data = h.encode("utf-8")
                th, jh = to.tokenize(data, unicode), jo.tokenize(data, unicode)
                assert th.cp == jh.cp and th.byte_off == jh.byte_off
                for t in (0, 1, 2):
                    assert (to.prefilter_window(tu, th, len(data), t)
                            == jo.prefilter_window(ju, jh, len(data), t))
                for pre in (False, True):
                    H, _ = sw_matrices(tu, th, scoring, pre)
                    JH, _ = j_sw_matrices(ju, jh, jscoring, pre)
                    assert H == JH
                    assert (to.sw_score(tu, th, scoring, pre)
                            == jo.sw_score(ju, jh, jscoring, pre))
                    if H[-1] and max(H[-1]) > 0:
                        assert match_end_col(H, th) == j_end_col(JH, jh)
                    assert (to.match_greedy(needle.encode(), data, scoring,
                                            cs, pre)
                            == jo.match_greedy(needle.encode(), data,
                                               jscoring, cs, pre))
                for mode in ("EXACT", "PREFIX", "SUFFIX", "SUBSTRING"):
                    assert (to.literal_find(needle, data, Matching[mode],
                                            unicode, cs, scoring)
                            == jo.literal_find(needle, data, JMatching[mode],
                                               unicode, cs, jscoring))


@pytest.mark.parametrize("cfg", [
    {"max_typos": 0}, {"max_typos": 1}, {"max_typos": None},
    {"matching": Matching.SUBSTRING}, {"matching": Matching.PREFIX},
])
def test_engine_host_pipelines_match_reference(cfg):
    """match_one and match_many of both engines over byte rows, greedy
    windows and XL rows, against the reference's engines (per-row and,
    where built, its native batch)."""
    rng = random.Random(17)
    rows = (_rows(rng, 60, ALPHA) + _xl_rows(rng, 6)
            + ["l" + "x" * 1100 + "inux", "LINUX", "linux"])
    for needle in ("linux", "L1x", "inu"):
        te = make_engine(needle, Config(**cfg))
        je = j_engine(needle, _jcfg(cfg), False)
        got, want = te.match_many(rows), je.match_many(rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for r, h in enumerate(rows[:30]):
            tm_, jm_ = te.match_one(h, r), je.match_one(h, r)
            assert (tm_ is None) == (jm_ is None)
            if tm_ is not None:
                assert (tm_.score, tm_.index, tm_.exact, tm_.end_col) == (
                    jm_.score, jm_.index, jm_.exact, jm_.end_col)


def _xl_corpus():
    rng = np.random.default_rng(5)
    pool = list("ghijklmnopqrstuvw")  # no needle chars
    xl = ["".join(rng.choice(pool, size=1500)) for _ in range(40)]
    xl[3] = xl[3][:700] + "deadbeef" + xl[3][700:]
    xl[17] = "d e a d b e e f " * 120  # matching, window > DP cap
    xl[21] = "DEAD" + xl[21] + "beef"
    return xl + ["deadbeef", "nope", "dxexaxdxbxexexf", "dead", "beefy"]


@pytest.mark.parametrize("unicode", [False, True])
def test_xl_presence_and_candidates_match_reference(unicode):
    hay = _xl_corpus() + ["إن" * 700, "é" * 1200 + "dead"]
    port = pack_corpus(hay, unicode=unicode, device="cpu")
    ref = j_pack(hay, unicode=unicode)
    np.testing.assert_array_equal(port.xl_indices, ref.xl_indices)
    assert len(port.xl_indices) >= 40
    np.testing.assert_array_equal(port.xl_presence(), ref.xl_presence())
    cfg = Config(unicode=UnicodeMatching.ALWAYS if unicode
                 else UnicodeMatching.SMART)
    for q in ("deadbeef", "dead !beef", "dead beef", "!dead", "'dead",
              "hij ^de"):
        for typos in (0, 1, None):
            c = Config(max_typos=typos, unicode=cfg.unicode)
            got = Matcher.from_query(q, c)._xl_candidates(port)
            want = JMatcher.from_query(q, _jcfg(
                {"max_typos": typos, "unicode": cfg.unicode}
            ))._xl_candidates(ref)
            np.testing.assert_array_equal(got, want)


def _topk_both(hay, queries, k, units=False, corpus=None, **cfg):
    port = corpus or pack_corpus(hay, unicode=units, device="cpu")
    ref = j_pack(hay, unicode=units)
    got = match_topk_batch(queries, port, Config(**cfg), k=k)
    want = j_topk(queries, ref, _jcfg(cfg), k=k)
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0], q
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got


@pytest.mark.parametrize("typos", [0, 1, None])
def test_xl_presence_gate_serving(typos):
    """The reference's XL presence-gate corpus: 40 rows of 1500 bytes,
    a few matching, one with a window past the DP cap; single, multi and
    negated queries."""
    got = _topk_both(_xl_corpus(), ["deadbeef", "dead beef", "dead !beef",
                                    "!dead"], 8, max_typos=typos)
    assert got[0][0] >= 2


def test_xl_heavy_topk_batch():
    """The reference's XL-heavy serving corpus (rows of 1100-3000 bytes
    embedding "linux"), at T=1, with a multi-pattern and a negated query
    and a literal one; counts past k come from the device plus the XL
    rows the host adds."""
    rng = random.Random(11)
    hay = _rows(rng, 64, ALPHA) + _xl_rows(rng, 30)
    got = _topk_both(hay, ["linux", "xy", "li nux", "linux !^l", "'nux"], 16,
                     max_typos=1)
    assert got[0][0] > 0 and got[2][0] > 0


def test_greedy_rows_serving():
    """Unicode rows whose trimmed window spans more than 1024 UTF-8 bytes
    are greedy-flagged on the device and rescored (or dropped) on the
    host; multi-pattern and negated queries combine on the host too."""
    hay = (["a" + "€" * 400 + "b", "ab", "xaxb", "b" + "€" * 500 + "a",
            "€" * 300 + "ab" + "€" * 300]
           + ["".join(random.Random(i).choice("ab€x") for _ in range(30))
              for i in range(40)])
    cfg = {"unicode": UnicodeMatching.ALWAYS}
    got = _topk_both(hay, ["ab", "a b", "ab !x", "'ab"], 64, units=True,
                     **cfg)
    assert got[0][0] > 3


def test_saved_reference_corpus_with_xl_rows(tmp_path):
    """A corpus packed and saved by frizbee_tpu, XL rows included, read
    through Corpus.load and served equal."""
    hay = _xl_corpus() + _rows(random.Random(4), 200, ALPHA)
    path = str(tmp_path / "corpus.npz")
    j_pack(hay, unicode=False).save(path)
    port = Corpus.load(path, device="cpu")
    assert len(port.xl_indices) >= 40
    _topk_both(hay, ["deadbeef", "dead !beef"], 8, corpus=port, max_typos=1)
