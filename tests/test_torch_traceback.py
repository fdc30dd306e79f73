"""The port's batched host traceback (``frizbee_tpu_torch/traceback.py``) and
the UTF-8 context arrays it reads (``PackedBucket._full_arrays``) against
frizbee_tpu's: the context arrays of byte and codepoint buckets, padding
included; ``prefilter_windows``, ``sw_fill`` (H and MM) and
``walk_indices`` on the same buckets; ``batched_match_indices`` against
the reference's NumPy branch (``_FORCE_NUMPY``) and its default (its
native fill and walk where that library builds) over typo budgets,
casing and delimiters, custom scoring and unicode; the chunked fill; and
the greedy and XL rows, served by the engine's native batch or, under
``_FORCE_NUMPY``, left to the per-row oracle.

Inputs are made from a seed, the same in both packages; every comparison
has zero tolerance (integer arrays element for element, results tuple for
tuple)."""

import numpy as np
import pytest

import frizbee_tpu.traceback as jtb
import frizbee_tpu_torch.traceback as ttb
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.datagen import HaystackGenerationOptions as JOptions
from frizbee_tpu.datagen import generate_haystack as j_generate
from frizbee_tpu.datagen import unicode_corpus as j_unicode_corpus
from frizbee_tpu.engine import FuzzyEngine as JFuzzyEngine
from frizbee_tpu.matcher import Matcher as JMatcher
from frizbee_tpu_torch import Config, Matcher, Scoring, datagen, pack_corpus
from frizbee_tpu_torch.engine import FuzzyEngine

OPTIONS = dict(seed=21, partial_match_percentage=0.5, match_percentage=0.35,
               median_length=32, std_dev_length=20, num_samples=600)
CASING = ["DeadBeef", "dead_beef", "dead/beef!", "DEADBEEF", "deadbeef",
          " deadbeef", "xx dead beef xx", "d-e-a-d-b-e-e-f"] * 16
# letters of the Arabic block without the needle's two
GREEDY_LETTERS = [chr(c) for c in range(0x0621, 0x064B)
                  if chr(c) not in "إن"]


@pytest.fixture(scope="module")
def hay():
    got = datagen.generate_haystack(
        "deadbeef", datagen.HaystackGenerationOptions(**OPTIONS))
    assert got == j_generate("deadbeef", JOptions(**OPTIONS))
    return got


@pytest.fixture(scope="module")
def arabic():
    kw = dict(num_samples=400, median_units=16, needle="إن",
              needle_every=3, seed=5)
    got = datagen.unicode_corpus("arabic", **kw)
    assert got == j_unicode_corpus("arabic", **kw)
    return got


def _engines(needle, **cfg):
    jcfg = dict(cfg)
    if "scoring" in jcfg:
        jcfg["scoring"] = JScoring(**vars(cfg["scoring"]))
    return (FuzzyEngine(needle, Config(**cfg)),
            JFuzzyEngine(needle, JConfig(**jcfg)))


def _buckets(rows, unicode):
    port = pack_corpus(rows, unicode=unicode, device="cpu")
    ref = j_pack(rows, unicode=unicode)
    assert [b.width for b in port.buckets] == [b.width for b in ref.buckets]
    return list(zip(port.buckets, ref.buckets))


@pytest.mark.parametrize("unicode", [False, True])
def test_full_arrays_equal_reference(hay, arabic, unicode):
    """The five context arrays, element for element over the whole bucket:
    size-class padding rows and the columns past each row's units too.
    Mixed byte lengths (1-4 UTF-8 bytes) on the codepoint side."""
    rows = (arabic + ["a\U0001F600bé" * 5, "ÀÉ-x", ""] if unicode
            else hay + ["é" * 20, "abفx"])
    for port, ref in _buckets(rows, unicode):
        got, want = port._full_arrays(), ref._full_arrays()
        assert port._full_arrays() is got  # cached
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("needle,typos,corpus", [
    ("deadbeef", 0, "hay"),
    ("deadbeef", 2, "hay"),
    ("DeadBe", 1, "casing"),
    ("إن", 0, "arabic"),
])
def test_fill_and_walk_stages_equal_reference(hay, arabic, needle, typos,
                                              corpus):
    """prefilter_windows, sw_fill's H and MM, and walk_indices on the same
    bucket arrays give the reference's outputs."""
    unicode = corpus == "arabic"
    rows = {"hay": hay, "casing": CASING, "arabic": arabic}[corpus]
    eng, _ = _engines(needle, max_typos=typos)
    orig = np.array(eng.units.orig, np.int32)
    flip = np.array(eng.units.flip, np.int32)
    scoring = Config().scoring
    jscoring = JConfig().scoring
    walked = 0
    for port, _ref in _buckets(rows, unicode):
        cp, fb, pb, bo, bl = port._full_arrays()
        nu, nb = port.n_units, port.n_bytes
        got = ttb.prefilter_windows(cp, bo, bl, nu, nb, orig, flip, typos)
        want = jtb.prefilter_windows(cp, bo, bl, nu, nb, orig, flip, typos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        matched, ws, we = got
        keep = np.nonzero(matched & (port.indices >= 0))[0]
        if keep.size == 0:
            continue
        ws = np.maximum(ws - 1, 0)[keep]
        args = (cp[keep], fb[keep], pb[keep], bo[keep], bl[keep], nu[keep],
                ws, we[keep], orig, flip)
        H, MM = ttb.sw_fill(*args, scoring)
        jH, jMM = jtb.sw_fill(*args, jscoring)
        np.testing.assert_array_equal(H, jH)
        np.testing.assert_array_equal(MM, jMM)
        score, inds = ttb.walk_indices(H, MM, bo[keep], bl[keep], typos)
        jscore, jinds = jtb.walk_indices(H, MM, bo[keep], bl[keep], typos)
        np.testing.assert_array_equal(score, jscore)
        assert inds == jinds
        walked += sum(map(bool, inds))
    assert walked > 0


def _batched_equal(rows, needle, **cfg):
    """The port's native fill and walk (its default) and its NumPy branch
    (``_FORCE_NUMPY``) both equal the reference's NumPy branch and its
    default."""
    eng, jeng = _engines(needle, **cfg)
    got = ttb.batched_match_indices(eng, rows)
    jtb._FORCE_NUMPY = ttb._FORCE_NUMPY = True
    try:
        numpy_branch = jtb.batched_match_indices(jeng, rows)
        port_numpy = ttb.batched_match_indices(eng, rows)
    finally:
        jtb._FORCE_NUMPY = ttb._FORCE_NUMPY = False
    assert got == numpy_branch
    assert port_numpy == numpy_branch
    assert got == jtb.batched_match_indices(jeng, rows)
    assert sum(r is not None and r[0] > 0 for r in got) > 0
    return got


@pytest.mark.parametrize("typos", [None, 0, 1, 2])
def test_batched_typos(hay, typos):
    _batched_equal(hay, "deadbeef", max_typos=typos)


def test_batched_casing_and_delimiters():
    _batched_equal(CASING, "DeadBeef")
    _batched_equal(CASING, "deadbeef", max_typos=1)


def test_batched_custom_scoring(hay):
    _batched_equal(hay, "dead", scoring=Scoring(
        match_score=24, gap_open_penalty=7, capitalization_bonus=9))


def test_batched_unicode(arabic):
    _batched_equal(arabic, "إن")


def test_batched_chunked_fill(hay, monkeypatch):
    """A fill budget of a few rows splits every bucket into many chunks;
    the results stay the reference's."""
    monkeypatch.setattr(ttb, "FILL_CELLS", 3 * 9 * 65)
    _batched_equal(hay, "deadbeef", max_typos=1)


def _row(m):
    return (m.score, m.index, m.exact, list(m.indices))


def _greedy_row(rng, units=600):
    """A bucketed codepoint row whose needle window spans more than the
    1024-byte DP cap: "إ", ``units`` two-byte letters, then "ن"."""
    return "إ" + "".join(rng.choice(GREEDY_LETTERS, size=units)) + "ن"


def test_greedy_and_xl_rows_fall_back(hay, arabic, monkeypatch):
    """Greedy windows and XL rows: under ``_FORCE_NUMPY`` the batched walk
    leaves them None and match_list_indices serves them through the
    per-row oracle; by default the engine's native batch
    (``match_many_indices``) serves them. Both equal the reference's
    native and oracle paths."""
    rng = np.random.default_rng(11)
    rows = arabic[:150] + [_greedy_row(rng) for _ in range(3)]
    greedy = [150, 151, 152]
    eng, jeng = _engines("إن")
    xl_rows = hay[:200] + ["x" * 700 + "deadbeef" + "y" * 700]
    xl = pack_corpus(xl_rows, device="cpu")
    assert list(xl.xl_indices) == [200]
    xl_eng, xl_jeng = _engines("deadbeef")

    native = ttb.batched_match_indices(eng, rows)
    assert all(native[i] is not None for i in greedy)
    assert native == jtb.batched_match_indices(jeng, rows)
    xl_native = ttb.batched_match_indices(xl_eng, xl_rows)
    assert xl_native[200] is not None
    assert xl_native == jtb.batched_match_indices(xl_jeng, xl_rows)
    for i in greedy:
        want = jeng.match_one_indices(rows[i], i)
        assert native[i] == (want.score, want.exact, want.indices)

    monkeypatch.setattr(ttb, "_FORCE_NUMPY", True)
    got = ttb.batched_match_indices(eng, rows)
    assert all(got[i] is None for i in greedy)
    assert sum(r is not None for r in got) >= 32
    assert [r for i, r in enumerate(got) if i not in greedy] == [
        r for i, r in enumerate(native) if i not in greedy]
    assert ttb.batched_match_indices(xl_eng, xl_rows)[200] is None
    for needle, corpus, unicode, must in (("إن", rows, True, greedy),
                                          ("deadbeef", xl_rows, False,
                                           [200])):
        for force in (True, False):
            monkeypatch.setattr(ttb, "_FORCE_NUMPY", force)
            dev = Matcher(needle, device="cpu").match_list_indices(corpus)
            want = JMatcher(needle).match_list_indices(corpus)
            oracle = JMatcher(needle,
                              use_device=False).match_list_indices(corpus)
            assert [_row(m) for m in dev] == [_row(m) for m in want]
            assert [_row(m) for m in dev] == [_row(m) for m in oracle]
            served = {m.index for m in dev}
            assert set(must) <= served and len(dev) >= 32
