"""Unicode serving in the port against frizbee_tpu: the (Q, 1 + k, 2)
arrays of both packages' ``_dispatch_batch_groups`` over codepoint-packed
Arabic and Korean corpora (the reference's calibrated sentence-corpus
generator, a few thousand rows) for fuzzy T=0 and T=1 (column-stream
fuzzy kernel), literal (column-stream literal kernel), T=4 (row-major
kernel) and an ASCII needle under ``UnicodeMatching.ALWAYS`` over a
mixed-script corpus; the decoded top-k against the reference's and its
host oracle; the per-query path's repack of a needle of the other unit
mode; and the device path's refusals.

Inputs are made from a seed and handed to both packages; every
comparison has zero tolerance. Column-stream batches compare element for
element; row-major batches compare the count header and the first
min(count, k) rows (the reference's survivor-capacity tiers fill the rows
past the count differently, and no caller reads them)."""

import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Matching as JMatching
from frizbee_tpu.config import UnicodeMatching as JUnicodeMatching
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu_torch import (
    Config,
    Matcher,
    UnicodeMatching,
    datagen,
    match_topk_batch,
    pack_corpus,
)

ARABIC = ["إن", "لا", "ما", "في", "من", "هل"]
KOREAN = ["니다", "하다", "있다", "없다", "보다", "가다"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# Both scripts pack into w32 (and w64) buckets of the same row counts, so
# the reference compiles each batch shape once for the two corpora
WIDTHS = (32, 64)


def _corpora(hay):
    return hay, pack_corpus(hay, unicode=True, bucket_widths=WIDTHS,
                            device="cpu"), j_pack(hay, unicode=True,
                                                  bucket_widths=WIDTHS)


@pytest.fixture(scope="module")
def arabic():
    return _corpora(datagen.unicode_corpus("arabic", needle="إن",
                                           num_samples=3000, seed=5))


@pytest.fixture(scope="module")
def korean():
    return _corpora(datagen.unicode_corpus("korean", needle="니다",
                                           num_samples=3000, seed=6))


def _jcfg(cfg):
    out = {}
    for key, v in cfg.items():
        if key == "unicode":
            v = JUnicodeMatching[v.name]
        elif key == "matching":
            v = JMatching[v.name]
        out[key] = v
    return JConfig(**out)


def _serve_both(corpora, queries, k, *, full=True, **cfg):
    """Both packages' serving arrays for one shape-uniform batch; the
    count header and the first min(count, k) rows, all rows when
    ``full``."""
    _hay, port, ref = corpora
    pm = [tm.Matcher.from_query(q, Config(**cfg)) for q in queries]
    (got, _ready, members), = tm._dispatch_batch_groups(
        pm, port, Config(**cfg), k)
    jms = [jm.Matcher.from_query(q, _jcfg(cfg)) for q in queries]
    jpending, _ = jm._dispatch_batch_groups(jms, ref, _jcfg(cfg), k)
    (want, jmembers), = jpending
    assert members == jmembers
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for q in range(got.shape[0]):
        m = 1 + min(int(got[q, 0, 0]), got.shape[1] - 1)
        np.testing.assert_array_equal(got[q, :m], want[q, :m])
    if full:
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("script", ["arabic", "korean"])
@pytest.mark.parametrize("typos", [0, 1])
def test_fuzzy_batches(request, script, typos):
    """Two-letter needles through the column-stream fuzzy flow with group
    flags and the finalize the reference takes."""
    corpora = request.getfixturevalue(script)
    queries = ARABIC if script == "arabic" else KOREAN
    out = _serve_both(corpora, queries, 40, max_typos=typos)
    assert out[0, 0, 0] > 40


@pytest.mark.parametrize("script", ["arabic", "korean"])
def test_literal_batches(request, script):
    """The same needles under ', ^, $ and ^...$ in turn: the column-stream
    literal flow groups them by mode, one batch each."""
    _hay, port, ref = request.getfixturevalue(script)
    base = ARABIC if script == "arabic" else KOREAN
    wraps = (("'", ""), ("^", ""), ("", "$"), ("^", "$"))
    total = 0
    for pre, post in wraps:
        out = _serve_both((_hay, port, ref),
                          [pre + q + post for q in base[:2]], 40)
        total += int(out[:, 0, 0].sum())
    assert total > 0


@pytest.mark.parametrize("script", ["arabic", "korean"])
def test_typo_batches(request, script):
    """Eight-codepoint needles (four consecutive variants) at max_typos=4:
    the row-major flow over each query's stage-1 survivors."""
    base = ARABIC if script == "arabic" else KOREAN
    queries = ["".join(base[i:i + 4]) for i in range(2)]
    before = dict(tbatch.ROW_MAJOR_ROUTES)
    out = _serve_both(request.getfixturevalue(script), queries, 40,
                      full=False, max_typos=4)
    assert tbatch.ROW_MAJOR_ROUTES["compacted"] == before["compacted"] + 1
    if script == "arabic":  # Korean rows rarely hold 4 of 8 syllables
        assert out[0, 0, 0] > 0


def test_always_ascii_needle_over_mixed_script_corpus():
    """An ASCII needle under UnicodeMatching.ALWAYS matches in codepoint
    units over a corpus of Arabic and ASCII rows, fuzzy and literal."""
    hay = datagen.unicode_corpus("arabic", needle="إن", num_samples=1500,
                                 seed=8)
    hay += datagen.partial_match_corpus(median_length=20, num_samples=1500,
                                        seed=9)
    hay += ["dead إن beef", "DEADBEEF", "deadbeef"]
    corpora = _corpora(hay)
    always = UnicodeMatching.ALWAYS
    out = _serve_both(corpora, ["deadbeef", "feedbead"], 40, unicode=always)
    assert out[0, 0, 0] > 0
    _serve_both(corpora, ["^dead", "^beef"], 40, unicode=always)


def test_topk_parity_with_reference_and_oracle(arabic):
    """match_topk_batch over the codepoint corpus against the reference's
    match_topk_batch and its host oracle."""
    from frizbee_tpu.matcher import Matcher as JMatcher

    _hay, port, ref = arabic
    queries, k = ARABIC[:3], 30
    got = match_topk_batch(queries, port, Config(), k=k)
    want = jm.match_topk_batch(queries, ref, JConfig(), k=k)
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0] > k
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
        oracle = JMatcher.from_query(q, JConfig(), use_device=False
                                     ).match_arrays(ref)
        assert g[0] == len(oracle[0])
        for a, b in zip(g[1:], oracle):
            np.testing.assert_array_equal(a, b[:k])


def test_strings_pack_in_codepoints_for_unicode_needles(monkeypatch):
    """A corpus given as strings packs in codepoint units when a needle
    respects unicode, in byte units otherwise."""
    packed = []

    def pack_on_cpu(hay, unicode=False):
        packed.append(unicode)
        return pack_corpus(hay, unicode=unicode, device="cpu")

    monkeypatch.setattr(tm, "pack_corpus", pack_on_cpu)
    hay = ["إن كان", "deadbeef", "في"]
    res = match_topk_batch(["إن"], hay, k=5)
    assert res[0][0] == 1 and list(res[0][1]) == [0]
    match_topk_batch(["dead"], hay, k=5)
    assert packed == [True, False]


def test_unit_mode_mismatch_raises(arabic):
    """An ASCII needle under SMART over a codepoint corpus (and a unicode
    needle over a byte corpus), formerly refused, takes the per-query
    path: the batch leaves it to ``Matcher.match_arrays``, which repacks
    the corpus in the needle's unit mode on its device, as the reference
    does."""
    hay, port, ref = arabic
    byte_hay = ["abc", "إن", "xabcx", "إنن abc"]
    cases = ((["abc", "إن"], port, ref, hay),
             (["إن", "abc"], pack_corpus(byte_hay, device="cpu"),
              j_pack(byte_hay, unicode=False), byte_hay))
    for queries, corpus, jcorpus, rows in cases:
        got = match_topk_batch(queries, corpus, Config(), k=5)
        want = jm.match_topk_batch(queries, jcorpus, JConfig(), k=5)
        oracle = [jm.Matcher.from_query(q, JConfig(), use_device=False)
                  .match_arrays(rows) for q in queries]
        for g, w, o in zip(got, want, oracle):
            assert g[0] == w[0] == len(o[0])
            for a, b, c in zip(g[1:], w[1:], o):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c[:5])
    assert got[0][0] > 0 and got[1][0] > 0


def test_greedy_row_raises():
    """A row whose trimmed window spans more than 1024 UTF-8 bytes is
    greedy-flagged on the device and rescored on the host: served equal
    to the reference (no longer refused)."""
    from frizbee_tpu.matcher import match_topk_batch as j_topk

    hay = ["a" + "€" * 400 + "b", "ab", "xaxb"]
    corpus = pack_corpus(hay, unicode=True, device="cpu")
    got = match_topk_batch(["ab"], corpus,
                           Config(unicode=UnicodeMatching.ALWAYS), k=10)
    want = j_topk(["ab"], j_pack(hay, unicode=True),
                  JConfig(unicode=JUnicodeMatching.ALWAYS), k=10)
    assert got[0][0] == want[0][0] == 3
    for a, b in zip(got[0][1:], want[0][1:]):
        np.testing.assert_array_equal(a, b)


def test_long_unicode_literal_refused():
    """Literal needles of more than 16 codepoints (refused on the device
    path before the generic pipelines were ported) take the literal
    pipeline, equal to the reference's device path, as the 16-codepoint
    needle on the column-stream kernel is."""
    hay = ["إن" * 9, "abc", "ءإن" * 9]
    corpus = pack_corpus(hay, unicode=True, device="cpu")
    for q in ("^" + "إن" * 8, "^" + "إن" * 8 + "ا", "'" + "إن" * 9):
        got = Matcher.from_query(q).match_arrays(corpus)
        want = jm.Matcher.from_query(q).match_arrays(hay)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(got[0]) >= 1 or "ا" in q
