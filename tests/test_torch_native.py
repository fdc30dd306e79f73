"""The port's native host components (``frizbee_tpu_torch/native/``) against
frizbee_tpu's and against the port's own NumPy and per-row twins (the test
hooks ``native._FORCE_NUMPY`` and ``traceback._FORCE_NUMPY``):

- the packer: bucket arrays of byte and codepoint corpora, size-class
  padding rows and custom widths included, and the UTF-8 context planes the
  port's codepoint packer no longer emits (``PackedBucket._full_arrays``
  derives them) against the reference packer's;
- the engines' batched host pipelines: fuzzy ``match_many`` (seeds,
  scoring variants, typo budgets, Arabic and XL-heavy rows), literal
  ``match_many`` and ``match_xl_rows``, ``Corpus.xl_blob`` /
  ``xl_presence``, ``match_many_indices`` and the native
  ``batched_match_indices``;
- served top-k over greedy and XL rows with the native host fixups;
- the C ``Match`` type, ``build_matches`` and ``MatchList`` iteration
  against the dataclass ``PY_MATCH``, pickling included;
- ``Corpus.save`` read by either package's ``load``;
- the build: a failed compile raises, the ctypes calls release the GIL.

Inputs are made from a seed and handed to both packages; every comparison
has zero tolerance (arrays element for element)."""

import ctypes
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import frizbee_tpu.corpus as jcorpus
import frizbee_tpu.traceback as jtb
import frizbee_tpu.types as jtypes
import frizbee_tpu_torch.native as native
import frizbee_tpu_torch.traceback as ttb
import frizbee_tpu_torch.types as ttypes
from frizbee_tpu.config import CaseMatching as JCaseMatching
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Matching as JMatching
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.datagen import partial_match_corpus as j_partial
from frizbee_tpu.engine import FuzzyEngine as JFuzzyEngine
from frizbee_tpu.engine import LiteralEngine as JLiteralEngine
from frizbee_tpu.matcher import Matcher as JMatcher
from frizbee_tpu.matcher import match_topk_batch as j_topk
from frizbee_tpu_torch import (
    Config,
    Corpus,
    Matcher,
    MatchList,
    datagen,
    match_topk_batch,
    pack_corpus,
)
from frizbee_tpu_torch.config import CaseMatching, Matching, Scoring
from frizbee_tpu_torch.engine import FuzzyEngine, LiteralEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = "abcdeABC_/. 01xyz"
UNI_ALPHA = "abcdeABC_/. éß다漢𝄞01"
ARABIC = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي إن"
# letters of the Arabic block without the needle's two
GREEDY_LETTERS = [chr(c) for c in range(0x0621, 0x064B) if chr(c) not in "إن"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def force_numpy(monkeypatch):
    """Turn the engines' and the packer's test hook on for one call."""

    def run(fn, *args, **kw):
        monkeypatch.setattr(native, "_FORCE_NUMPY", True)
        try:
            return fn(*args, **kw)
        finally:
            monkeypatch.setattr(native, "_FORCE_NUMPY", False)

    return run


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


def _greedy_row(rng, units=600):
    """A bucketed codepoint row whose needle window spans more than the
    1024-byte DP cap: "إ", ``units`` two-byte letters, then "ن"."""
    return "إ" + "".join(rng.choice(GREEDY_LETTERS) for _ in range(units)) \
        + "ن"


def _jscoring(sc):
    return None if sc is None else JScoring(**vars(sc))


def _fuzzy(needle, typos=0, scoring=None):
    cfg = {} if scoring is None else {"scoring": scoring}
    jcfg = {} if scoring is None else {"scoring": _jscoring(scoring)}
    return (FuzzyEngine(needle, Config(max_typos=typos, **cfg)),
            JFuzzyEngine(needle, JConfig(max_typos=typos, **jcfg)))


def _assert_arrays(got, want, msg=""):
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(msg))


# -- packer ------------------------------------------------------------------

_PRNG = random.Random(6)
# enough rows a width class for several buckets (sparse ones merge)
PACK_CASES = (
    _rows(_PRNG, 1300, ALPHA, 0, 16) + _rows(_PRNG, 1300, UNI_ALPHA, 17, 40)
    + _rows(_PRNG, 300, UNI_ALPHA, 41, 300)
    + ["héllo wörld 漢字", "ß" * 10, "", "x" * 3000, "𝄞 clef", "γειά",
       "إن" * 300]
)


@pytest.mark.parametrize("unicode", [False, True])
@pytest.mark.parametrize("widths", [None, (8, 24, 100)])
def test_packer_equals_reference_and_numpy(unicode, widths, force_numpy):
    """Every bucket array of the native packing equals the reference's
    native packing and the port's NumPy twin: size-class padding rows
    (index -1, no units), custom widths, the chained buckets' row order
    and the XL set. The codepoint packer emits the codepoints only; the
    four UTF-8 context planes the reference packer also writes derive in
    ``_full_arrays`` and equal them."""
    port = pack_corpus(PACK_CASES, unicode=unicode, bucket_widths=widths,
                       device="cpu")
    twin = force_numpy(pack_corpus, PACK_CASES, unicode=unicode,
                       bucket_widths=widths, device="cpu")
    ref = j_pack(PACK_CASES, unicode=unicode, bucket_widths=widths)
    assert len(port.buckets) == len(twin.buckets) == len(ref.buckets) > 1
    np.testing.assert_array_equal(port.xl_indices, ref.xl_indices)
    np.testing.assert_array_equal(twin.xl_indices, ref.xl_indices)
    padded = 0
    for p, t, r in zip(port.buckets, twin.buckets, ref.buckets):
        assert p.width == t.width == r.width
        assert p.cp.dtype == t.cp.dtype == r.cp.dtype
        for name in ("indices", "cp", "n_units", "n_bytes"):
            np.testing.assert_array_equal(getattr(p, name), getattr(r, name))
            np.testing.assert_array_equal(getattr(t, name), getattr(r, name))
            assert getattr(p, name).dtype == getattr(r, name).dtype, name
        padded += int(np.sum(p.indices < 0))
        if unicode:
            assert r.first_byte is not None  # the reference packed them
        _assert_arrays(p._full_arrays(), r._full_arrays(), p.width)
    assert padded > 0


def test_utf8_lengths_and_wrapper_checks():
    rng = random.Random(3)
    rows = _rows(rng, 50, UNI_ALPHA) + ["", "𝄞" * 9]
    u32 = np.frombuffer("".join(rows).encode("utf-32-le"), np.uint32)
    starts = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(h) for h in rows], out=starts[1:])
    np.testing.assert_array_equal(
        native.utf8_lengths(u32, starts),
        [len(h.encode("utf-8")) for h in rows])
    joined = "".join(rows).encode("utf-8")
    with pytest.raises(IndexError):
        native.pack_rows_u8(joined, starts, np.array([len(rows)]), 8)
    with pytest.raises(IndexError):
        native.pack_rows_u32(u32, starts, np.array([-2]), 8)
    with pytest.raises(ValueError):
        native.pack_rows_u8(joined, starts[::-1], np.array([0]), 8)


# -- fuzzy host batch --------------------------------------------------------

def _fuzzy_equal(needle, rows, typos, force_numpy, scoring=None):
    """match_many == the reference's == the per-row pipeline (the hook)
    == ``_host_pipeline`` row by row."""
    eng, jeng = _fuzzy(needle, typos, scoring)
    got = eng.match_many(rows)
    _assert_arrays(got, jeng.match_many(rows), (needle, typos))
    _assert_arrays(got, force_numpy(eng.match_many, rows), (needle, typos))
    assert got[1].dtype == np.int64 and got[3].dtype == np.int64
    return got


@pytest.mark.parametrize("seed", range(4))
def test_fuzzy_match_many(seed, force_numpy):
    rng = random.Random(1000 + seed)
    rows = (_rows(rng, 50, ALPHA) + _xl_rows(rng, 4)
            + ["", "l", "linux", "LINUX", "Linux" * 400])
    hits = 0
    for needle in ("linux", "Li", "a_b.c"):
        for typos in (0, 1, 3, None):
            m = _fuzzy_equal(needle, rows, typos, force_numpy)[0]
            hits += int(m.sum())
    assert hits > 0


def test_fuzzy_match_many_scoring_variants(force_numpy):
    rng = random.Random(77)
    rows = _rows(rng, 30, ALPHA) + _xl_rows(rng, 4)
    for sc in (
        Scoring(match_score=255, mismatch_penalty=1, gap_open_penalty=255,
                gap_extend_penalty=120, prefix_bonus=200,
                capitalization_bonus=7, matching_case_bonus=9,
                exact_match_bonus=250, delimiter_bonus=11),
        Scoring(match_score=1, mismatch_penalty=0, gap_open_penalty=0,
                gap_extend_penalty=0, prefix_bonus=0,
                capitalization_bonus=0, matching_case_bonus=0,
                exact_match_bonus=0, delimiter_bonus=0),
    ):
        for typos in (0, 2, None):
            _fuzzy_equal("Linux", rows, typos, force_numpy, scoring=sc)


def test_fuzzy_match_many_unicode_and_greedy(force_numpy):
    """Codepoint engines (host_match_batch_u32): Arabic rows, multi-byte
    scalars straddling the start-1 window trim, greedy windows."""
    rng = random.Random(2000)
    rows = _rows(rng, 40, UNI_ALPHA) + _rows(rng, 30, ARABIC) + [
        "é" + "다" * 700 + "B", "é" + "x" * 1500 + "다", "다" * 600,
        "L" + "é" * 800 + "inux", "", "é", "zz",
    ] + [_greedy_row(rng) for _ in range(3)]
    for needle in ("é다", "éB", "إن"):
        for typos in (0, 1, None):
            eng = _fuzzy_equal(needle, rows, typos, force_numpy)
            assert FuzzyEngine(needle, Config()).unicode
            assert eng[0].any()


# -- literal host batch ------------------------------------------------------

LIT_ROWS = [
    "DeadBeef", "deadbeef", "xxdeadbeefxx", "dead beef", "DEADBEEF", "",
    "beefdead", "a/dead_beef/b", "deadbee",
    "Dead/Beef and deadbeef twice DeadBeef", "d",
    "the beef is dead but DeadBeef deAdBeEf", "ümläut deadbeef ümläut",
    "  deadbeef", "deadbeef then /deadbeef (delimiter bonus later)",
    "إن الكتاب", "كتاب إن", "إنإن", "ẞstraße", "straße ẞ",
]


@pytest.mark.parametrize("mode", ["EXACT", "PREFIX", "SUFFIX", "SUBSTRING"])
def test_literal_match_many(mode, force_numpy):
    for needle in ("deadbeef", "DeadBeef", "dead", "beef", "إن", "ẞ",
                   "straße"):
        for case in ("SMART", "RESPECT"):
            eng = LiteralEngine(needle, Config(
                matching=Matching[mode], casing=CaseMatching[case]),
                use_device=False)
            jeng = JLiteralEngine(needle, JConfig(
                matching=JMatching[mode], casing=JCaseMatching[case]),
                use_device=False)
            got = eng.match_many(LIT_ROWS)
            _assert_arrays(got, jeng.match_many(LIT_ROWS), (needle, case))
            _assert_arrays(got, force_numpy(eng.match_many, LIT_ROWS),
                           (needle, case))


def test_literal_xl_rows_and_corpus(force_numpy):
    rng = random.Random(8)
    long_rows = [
        "x" * 1500 + "deadbeef" + "y" * 10, "z" * 1500,
        "deadbeef" + "w" * 1500, "DeadBeef" + "é" * 1200,
    ]
    hay = _rows(rng, 40, ALPHA + "deadbf") + long_rows
    corpus = pack_corpus(hay, device="cpu")
    jc = j_pack(hay, unicode=False)
    assert len(corpus.xl_indices) == 4
    for mode in ("SUBSTRING", "PREFIX", "EXACT"):
        eng = LiteralEngine("deadbeef", Config(matching=Matching[mode]))
        jeng = JLiteralEngine("deadbeef", JConfig(matching=JMatching[mode]))
        for pos in (np.arange(4), np.array([3, 1])):
            got = eng.match_xl_rows(corpus, pos)
            _assert_arrays(got, jeng.match_xl_rows(jc, pos), mode)
            rows = [hay[int(i)] for i in corpus.xl_indices[pos]]
            _assert_arrays(got, force_numpy(eng.match_many, rows), mode)
        assert force_numpy(eng.match_xl_rows, corpus, np.arange(4)) is None
        host = LiteralEngine("deadbeef", Config(matching=Matching[mode]),
                             use_device=False)
        res = host.match_corpus(corpus)
        twin = force_numpy(host.match_corpus, corpus)
        jres = JLiteralEngine("deadbeef", JConfig(
            matching=JMatching[mode]), use_device=False).match_corpus(jc)
        for name in ("matched", "score", "exact", "end_col"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(jres, name))
            np.testing.assert_array_equal(getattr(twin, name),
                                          getattr(jres, name))


# -- XL blob -----------------------------------------------------------------

@pytest.mark.parametrize("unicode", [False, True])
def test_xl_blob_presence_and_rows(unicode, force_numpy):
    """``xl_blob`` and ``xl_presence`` equal the reference's; the fuzzy
    ``match_xl_rows`` off the blob equals ``match_many`` on the strings,
    the reference's and the per-row twin, for the full set and subsets."""
    rng = random.Random(31)
    alpha = UNI_ALPHA if unicode else "abcdeABC_/. 01"
    hay = _rows(rng, 30, alpha) + [
        "".join(rng.choice(alpha) for _ in range(rng.randint(1100, 2500)))
        for _ in range(12)
    ]
    corpus = pack_corpus(hay, unicode=unicode, device="cpu")
    jc = j_pack(hay, unicode=unicode)
    assert len(corpus.xl_indices) >= 12
    blob, jblob = corpus.xl_blob(), jc.xl_blob()
    assert blob is corpus.xl_blob() and sorted(blob) == sorted(jblob)
    for key in blob:
        if key == "joined":
            assert blob[key] == jblob[key]
        else:
            np.testing.assert_array_equal(blob[key], jblob[key])
            assert blob[key].dtype == jblob[key].dtype
    np.testing.assert_array_equal(corpus.xl_presence(), jc.xl_presence())
    pos = np.arange(len(corpus.xl_indices))
    for needle in (("é다", "다a") if unicode else ("linux", "aB")):
        for typos in (0, 2, None):
            eng, jeng = _fuzzy(needle, typos)
            if eng.unicode != unicode:
                continue
            rows = [hay[int(i)] for i in corpus.xl_indices]
            want = jeng.match_many(rows)
            for sub in (pos, pos[::3]):
                got = eng.match_xl_rows(corpus, sub)
                _assert_arrays(got, jeng.match_xl_rows(jc, sub))
                _assert_arrays(got, [np.asarray(w)[sub] for w in want])
                _assert_arrays(got, force_numpy(
                    eng.match_many, [rows[int(i)] for i in sub]))
    # a unicode engine over a byte corpus's blob has no codepoints to read
    if not unicode:
        assert FuzzyEngine("é다", Config()).match_xl_rows(corpus, pos) is None


# -- indices -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_match_many_indices(seed):
    """The native batched score and traceback == the reference's == the
    per-row match_one_indices, byte and codepoint, long and short rows,
    greedy windows included."""
    rng = random.Random(4000 + seed)
    for needle, alpha in (("deadbeef", "abcdefABC_/. 01"),
                          ("é다", UNI_ALPHA)):
        rows = _rows(rng, 30, alpha) + _rows(rng, 5, alpha, 1100, 2400) + [
            needle, needle * 300, ""]
        for typos in (0, 1, None):
            eng, jeng = _fuzzy(needle, typos)
            got = eng.match_many_indices(rows)
            assert got == jeng.match_many_indices(rows), (needle, typos)
            served = 0
            for r, h in enumerate(rows):
                want = eng.match_one_indices(h, r)
                if want is None:
                    assert got[r] is None, (needle, typos, r)
                    continue
                assert got[r][:2] == (want.score, want.exact)
                if want.score > 0:
                    assert got[r][2] == want.indices, (needle, typos, r)
                    served += 1
            assert served > 0


def test_batched_match_indices_native(monkeypatch):
    """``batched_match_indices``: the native fill and walk plus the native
    tail over greedy and XL rows equals the reference's default, and
    equals the port's NumPy branch with the per-row oracle on the rows
    that branch leaves None."""
    rng = random.Random(12)
    hay = (datagen.generate_haystack("deadbeef",
                                     datagen.HaystackGenerationOptions(
                                         seed=4, num_samples=150,
                                         median_length=32))
           + ["x" * 700 + "deadbeef" + "y" * 700, "deadbeef" * 200])
    arabic = _rows(rng, 60, ARABIC) + [_greedy_row(rng) for _ in range(3)]
    for needle, rows, typos in (("deadbeef", hay, 1), ("deadbeef", hay, None),
                                ("إن", arabic, 0)):
        eng, jeng = _fuzzy(needle, typos)
        got = ttb.batched_match_indices(eng, rows)
        assert got == jtb.batched_match_indices(jeng, rows)
        monkeypatch.setattr(ttb, "_FORCE_NUMPY", True)
        twin = ttb.batched_match_indices(eng, rows)
        monkeypatch.setattr(ttb, "_FORCE_NUMPY", False)
        tail = [i for i, r in enumerate(twin) if r is None]
        assert any(got[i] is not None for i in tail)
        for i, r in enumerate(got):
            if i in tail:
                want = eng.match_one_indices(rows[i], i)
                assert r == (None if want is None else
                             (want.score, want.exact, want.indices))
            else:
                assert r == twin[i]


# -- served top-k with the native host fixups --------------------------------

def test_served_xl_and_greedy_rows_native_equals_twin(force_numpy):
    """match_topk_batch over XL-row and greedy-row corpora: the native
    host fixups (XL rows off the blob, greedy rows batched) equal the
    per-row twin and the reference, multi-pattern and negated too."""
    rng = random.Random(9)
    hay = (_rows(rng, 60, ALPHA) + _xl_rows(rng, 16)
           + ["l" + "x" * 600 + "inux" for _ in range(6)])
    rng.shuffle(hay)
    corpus = pack_corpus(hay, device="cpu")
    queries = ["linux", "lin !xyz"]
    cfg = Config(max_typos=1)
    got = match_topk_batch(queries, corpus, cfg, k=24)
    twin = force_numpy(match_topk_batch, queries, corpus, cfg, k=24)
    want = j_topk(queries, hay, JConfig(max_typos=1), k=24)
    for g, t, w in zip(got, twin, want):
        assert g[0] == t[0] == w[0] > 0
        _assert_arrays(g[1:], t[1:])
        _assert_arrays(g[1:], w[1:])
    arabic = _rows(rng, 60, ARABIC) + [_greedy_row(rng) for _ in range(5)]
    ucorpus = pack_corpus(arabic, unicode=True, device="cpu")
    got = Matcher("إن", device="cpu").match_arrays(ucorpus)
    twin = force_numpy(Matcher("إن", device="cpu").match_arrays, ucorpus)
    want = JMatcher("إن").match_arrays(arabic)
    _assert_arrays(got, twin)
    _assert_arrays(got, want)
    assert len(set(range(60, 65)) & set(got[0].tolist())) > 0


# -- C Match type ------------------------------------------------------------

def _both(*args, **kw):
    return ttypes.Match(*args, **kw), ttypes.PY_MATCH(*args, **kw)


def test_c_match_against_dataclass():
    """Construction, fields, repr, mutation, equality, ordering, serde
    and class methods of the C type equal the dataclass's."""
    M = ttypes.Match
    assert M is not ttypes.PY_MATCH
    assert M.__module__ == "frizbee_tpu_torch.native.fastmatch"
    assert M.__name__ == jtypes.Match.__name__ == "Match"
    for args, kw in [((), {}), ((5,), {}), ((5, 2), {}), ((5, 2, True), {}),
                     ((5, 2, True, 9), {}),
                     ((), dict(score=7, index=3, exact=True, end_col=1)),
                     ((7,), dict(index=3))]:
        c, p = _both(*args, **kw)
        assert (c.score, c.index, c.exact, c.end_col) == (
            p.score, p.index, p.exact, p.end_col)
        assert isinstance(c.exact, bool)
        assert repr(c) == repr(p)
        assert c.to_dict() == p.to_dict() and c.sort_key() == p.sort_key()
    c, p = _both(score=1, index=2)
    for m in (c, p):
        m.score, m.exact, m.end_col = 9, np.True_, 5
    assert (c.score, c.exact, c.end_col) == (p.score, True, p.end_col)
    c.exact = 0
    assert c.exact is False
    assert M(1, 2, True, 3) == M(1, 2, True, 3) and M(1, 2) != M(1, 3)
    assert M(1, 2, True) != M(1, 2, False)
    ms = [M(1, 5), M(3, 1), M(3, 0)]
    ps = [ttypes.PY_MATCH(1, 5), ttypes.PY_MATCH(3, 1),
          ttypes.PY_MATCH(3, 0)]
    assert [m.to_dict() for m in sorted(ms)] == [
        m.to_dict() for m in sorted(ps)]
    assert (M(1, 2) < M(1, 3)) == (ttypes.PY_MATCH(1, 2)
                                   < ttypes.PY_MATCH(1, 3))
    assert M.from_dict({"score": 1.0, "index": 2, "exact": 1}).to_dict() \
        == ttypes.PY_MATCH.from_dict(
            {"score": 1.0, "index": 2, "exact": 1}).to_dict()
    assert M.from_index(6).to_dict() == ttypes.PY_MATCH.from_index(
        6).to_dict()


def test_build_matches_and_match_list():
    idx = np.array([3, 1, 2], np.int64)
    sc = np.array([10, 0, 65535], np.int64)
    ex = np.array([1, 0, 1], np.uint8)
    ec = np.array([7, 0, 16383], np.int64)
    M = ttypes.Match
    out = ttypes.build_matches(idx, sc, ex, ec)
    assert out == [M(10, 3, True, 7), M(0, 1, False, 0),
                   M(65535, 2, True, 16383)]
    with pytest.raises(ValueError):
        ttypes.build_matches(idx, sc[:2], ex, ec)
    cols = (idx, sc, ex.astype(bool), ec)
    ml, jml = MatchList(*cols), jtypes.MatchList(*cols)
    got = list(ml)
    assert all(type(m) is M for m in got)
    assert got == [ml[0], ml[1], ml[2]]
    assert [m.to_dict() for m in got] == [m.to_dict() for m in jml]
    hay = ["deadbeef", "dead", "nope", "DeadBeef"]
    it = list(Matcher("dead", device="cpu").match_iter(hay))
    assert all(type(m) is M for m in it)
    assert [m.to_dict() for m in it] == sorted(
        (m.to_dict() for m in JMatcher("dead").match_list(hay)),
        key=lambda d: d["index"])


def test_c_match_pickle_round_trip():
    """pickle and copy round trips; in a fresh process the pickle
    resolves through ``frizbee_tpu_torch.types._rebuild_match`` without
    importing the reference or JAX."""
    import copy

    m = ttypes.Match(score=9, index=4, exact=True, end_col=2)
    assert pickle.loads(pickle.dumps(m)) == m
    assert copy.copy(m) == m and copy.deepcopy(m) == m
    blob = pickle.dumps(m)
    assert b"frizbee_tpu_torch.types" in blob and b"_rebuild_match" in blob
    code = (
        "import pickle, sys\n"
        f"m = pickle.loads(bytes.fromhex('{blob.hex()}'))\n"
        "import frizbee_tpu_torch.types as t\n"
        "print(type(m) is t.Match, m.score, m.index, m.exact, m.end_col,\n"
        "      'frizbee_tpu' in sys.modules, 'jax' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "True 9 4 True 2 False False", \
        out.stderr[-800:]


# -- Corpus.save -------------------------------------------------------------

SAVE_HAY = {
    False: j_partial(median_length=40, num_samples=400, seed=8)
    + ["x" * 1100 + "deadbeef", "DeadBeef"],
    True: datagen.unicode_corpus("arabic", num_samples=300, median_units=16,
                                 needle="إن", needle_every=3, seed=5)
    + ["إ" + "ب" * 1100 + "ن", "é다" * 5],
}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("unicode", [False, True])
def test_save_read_by_both_packages(unicode, tmp_path):
    """Port save -> reference load: the buckets (context planes included)
    equal the reference's own packing and serve equal. Reference save ->
    port load -> port save: the two files hold equal arrays. The path is
    used verbatim."""
    hay = SAVE_HAY[unicode]
    port = pack_corpus(hay, unicode=unicode, device="cpu")
    ref = j_pack(hay, unicode=unicode)
    path = str(tmp_path / "port_corpus")
    port.save(path)
    assert os.listdir(tmp_path) == ["port_corpus"]
    loaded = jcorpus.Corpus.load(path)
    assert loaded.haystacks == ref.haystacks and loaded.unicode == unicode
    np.testing.assert_array_equal(loaded.xl_indices, ref.xl_indices)
    assert len(loaded.buckets) == len(ref.buckets)
    for lb, rb in zip(loaded.buckets, ref.buckets):
        assert lb.width == rb.width
        for name in ("indices", "cp", "n_units", "n_bytes"):
            np.testing.assert_array_equal(getattr(lb, name),
                                          getattr(rb, name))
        _assert_arrays(lb._full_arrays(), rb._full_arrays(), lb.width)
    needle = "إن" if unicode else "deadbeef"
    for typos in (0, 1):
        want = JMatcher(needle, JConfig(max_typos=typos)).match_arrays(ref)
        _assert_arrays(JMatcher(needle, JConfig(max_typos=typos))
                       .match_arrays(loaded), want, typos)
        got = Matcher(needle, Config(max_typos=typos), device="cpu") \
            .match_arrays(Corpus.load(path, device="cpu"))
        _assert_arrays(got, want, typos)

    ref_path = str(tmp_path / "ref_corpus")
    ref.save(ref_path)
    again = str(tmp_path / "port_again")
    Corpus.load(ref_path, device="cpu").save(again)
    a, b = _npz(ref_path), _npz(again)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# -- build ---------------------------------------------------------------------

def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or a missing compiler, raises with
    the compiler's output; nothing is installed."""
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path / "b"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="native build failed") as e:
        native._compile(str(bad), "bad", ".so", native.PACKER_CMD)
    assert "error" in str(e.value)
    assert os.listdir(tmp_path / "b") == []
    with pytest.raises(RuntimeError, match="not found"):
        native._compile(str(bad), "bad", ".so",
                        ("no-such-compiler-frz", "-shared"))
    good = tmp_path / "good.c"
    good.write_text("int seven(void) { return 7; }\n")
    so = native._compile(str(good), "good", ".so", ("gcc", "-shared",
                                                    "-fPIC"))
    assert ctypes.CDLL(so).seven() == 7
    assert native._compile(str(good), "good", ".so",
                           ("gcc", "-shared", "-fPIC")) == so


def test_library_releases_the_gil_and_builds_in_the_package():
    """ctypes.CDLL entry points drop the GIL for the length of a call
    (a PyDLL's would not), so the pack stage of ``match_iter``'s thread
    pool overlaps the caller; the builds live under the package's
    ``_build/native/<host tag>/``."""
    lib = native.get_lib()
    assert not isinstance(lib, ctypes.PyDLL)
    assert not lib.pack_rows_u8._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert native.omp_threads() >= 1
    build = os.path.join(ROOT, "frizbee_tpu_torch", "_build", "native")
    assert os.path.dirname(native.build_dir()) == build
    assert os.path.dirname(lib._name) == native.build_dir()
    assert os.path.dirname(
        sys.modules[native.FASTMATCH_MODULE].__file__) == native.build_dir()
