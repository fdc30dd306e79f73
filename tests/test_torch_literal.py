"""Literal serving (exact, prefix, suffix, substring) in the port against
frizbee_tpu: the column-stream literal kernel's plain version (which the
CUDA kernel ``csrc/colstream_literal.cu`` is held against on the card)
against the reference's ``match_units_colstream`` in a literal mode, run
in interpret mode, and literal batches served by both packages.

Inputs are made with numpy from a seed and handed to both packages.
Every comparison has zero tolerance: the five result columns, the int64
key against the reference's (hi << 32) | lo halves, and the
(Q, 1 + k, 2) serving arrays element for element (both packages serve
literal batches through the same in-place flow)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import frizbee_tpu.matcher as jm
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Scoring as JScoring
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import LiteralEngine as JLiteralEngine
from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu.ops.kernels import pack_needle_scalars as j_pack_scalars
from frizbee_tpu_torch import Config, Matcher, datagen, match_topk_batch
from frizbee_tpu_torch import pack_corpus
from frizbee_tpu_torch.config import Matching, Scoring
from frizbee_tpu_torch.engine import LiteralEngine
from frizbee_tpu_torch.ops import colstream as tcs
from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING, pack_needle_scalars
from frizbee_tpu_torch.ops.literal import LITERAL_MODES

GR = 1024
MODES = list(LITERAL_MODES)
SCORINGS = [DEFAULT_SCORING, (10, 3, 1, 2, 7, 5, 2, 6, 9)]
MODE_PREFIX = {"exact": ("^", "$"), "prefix": ("^", ""),
               "suffix": ("", "$"), "substring": ("'", "")}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _blocks(cp, nu):
    """(cpT (nG*W, 8, 128) int8, nuT (nG*8, 128) int32) from row-major
    (B, W) bytes, B a multiple of 1024."""
    B, W = cp.shape
    nG = B // GR
    cpT = np.ascontiguousarray(
        cp.reshape(nG, GR, W).transpose(0, 2, 1)
    ).reshape(nG * W, 8, 128)
    return cpT, nu.reshape(nG * 8, 128).astype(np.int32)


def _rows(rng, nG, W, alphabet=4):
    """Random rows of 0..W units with capitals and '/' delimiters, half
    of them short, so short needles find runs at every position."""
    B = nG * GR
    cp = rng.integers(97, 97 + alphabet, (B, W)).astype(np.int32)
    nu = np.where(
        rng.random(B) < 0.5, rng.integers(0, 8, B), rng.integers(0, W + 1, B)
    ).astype(np.int32)
    cp = np.where(rng.random((B, W)) < 0.2, cp - 32, cp)
    cp = np.where(rng.random((B, W)) < 0.1, 47, cp)
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    return cp.astype(np.int8), nu


def _needles(rng, Q, n, alphabet=4):
    o = rng.integers(97, 97 + alphabet, (Q, n)).astype(np.int32)
    o = np.where(rng.random((Q, n)) < 0.2, o - 32, o)
    f = np.where(rng.random((Q, n)) < 0.5,
                 np.where(o >= 97, o - 32, o + 32), o)
    return np.concatenate([o, f], axis=1)


def _run_both(cpT, nuT, needles, flags, idxT, count, *, W, mode,
              scoring=DEFAULT_SCORING, idx_bits=0):
    """(reference per query, port batched) results."""
    n = needles.shape[1] // 2
    kw = dict(W=W, n=n, scoring=scoring, mode=mode, needle_byte_len=n)
    got = tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT),
        pack_needle_scalars(torch.from_numpy(needles), count),
        None if flags is None else torch.from_numpy(flags),
        None if idxT is None else torch.from_numpy(idxT),
        idx_bits=idx_bits, **kw,
    )
    want = [
        jcs.match_units_colstream(
            jnp.asarray(cpT), jnp.asarray(nuT),
            j_pack_scalars(jnp.asarray(needles[q]), count),
            None if flags is None else jnp.asarray(flags[q]),
            None if idxT is None else jnp.asarray(idxT.reshape(-1, 128)),
            interpret=True, idx_bits=idx_bits, **kw,
        )
        for q in range(needles.shape[0])
    ]
    return want, got


def _assert_cols_equal(want, got):
    for q, w in enumerate(want):
        for i in range(5):
            np.testing.assert_array_equal(
                got[i][q].numpy(), np.asarray(w[i]), err_msg=f"q{q} col{i}"
            )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", [16, 64, 128])
def test_literal_columns(mode, W):
    """Five-column mode over two groups of uneven rows, needles of 1, 3
    and 16 units (case-flipped units included), two scorings."""
    rng = np.random.default_rng(W + len(mode))
    cp, nu = _rows(rng, 2, W)
    cpT, nuT = _blocks(cp, nu)
    for n, scoring in ((1, SCORINGS[0]), (3, SCORINGS[1]),
                       (16, SCORINGS[0])):
        needles = _needles(rng, 1, n)
        want, got = _run_both(cpT, nuT, needles, None, None, cp.shape[0],
                              W=W, mode=mode, scoring=scoring)
        _assert_cols_equal(want, got)
        if n == 1:
            assert int(got[0].sum()) > 0
        assert not got[4].any()  # literal runs never take greedy


@pytest.mark.parametrize("mode", MODES)
def test_literal_key_emit_with_flags(mode):
    """Key-emit mode with alive and dead groups, padding rows (index -1)
    and a live-row count that ends inside the last group."""
    rng = np.random.default_rng(70 + len(mode))
    W = 32
    cp, nu = _rows(rng, 3, W, alphabet=3)
    cpT, nuT = _blocks(cp, nu)
    idx = rng.permutation(3 * GR).astype(np.int32)
    idx[rng.random(3 * GR) < 0.05] = -1
    needles = _needles(rng, 2, 2, alphabet=3)
    flags = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    want, got = _run_both(cpT, nuT, needles, flags, idx, 2 * GR + 100,
                          W=W, mode=mode, idx_bits=12)
    sent = np.int64(0x7FFFFFFFFFFFFFFF)
    for q, (hi, lo, m) in enumerate(want):
        k = (np.asarray(hi).astype(np.int64) << 32) | (
            np.asarray(lo).astype(np.int64) & 0xFFFFFFFF
        )
        np.testing.assert_array_equal(got[q].numpy(), k, err_msg=f"q{q}")
        np.testing.assert_array_equal(
            (got[q].numpy() != sent).astype(np.int32), np.asarray(m)
        )
    assert (got[0][GR:2 * GR].numpy() == sent).all()  # dead group
    assert (got[0].numpy() != sent).any()


@pytest.mark.parametrize("mode", MODES)
def test_literal_structured_rows(mode):
    """Whole-row runs (exact bonus), runs at the start, the end and the
    middle, case flips, delimiter and capitalization context, repeated
    runs (earliest best wins), short and empty rows."""
    needle = np.frombuffer(b"BeeF", np.uint8).astype(np.int32)
    flip = np.where(
        (needle >= 65) & (needle <= 90), needle + 32,
        np.where((needle >= 97) & (needle <= 122), needle - 32, needle),
    )
    rows = [
        b"BeeF", b"beef", b"BeeFx", b"xBeeF", b"dead/BeeF", b"deadBeeF",
        b"", b"Bee", b"BEEF", b"beefBeeF", b"BeeFbeef", b"x-beef-BeeF-y",
        b"aBeeFaBeeF", b"BeeF/", b"/BeeF", b"bEEf",
    ]
    W = 16
    cp = np.zeros((GR, W), np.int8)
    nu = np.zeros(GR, np.int32)
    for i, r in enumerate(rows):
        cp[i, : len(r)] = np.frombuffer(r, np.uint8).astype(np.int8)
        nu[i] = len(r)
    cpT, nuT = _blocks(cp, nu)
    needles = np.concatenate([needle, flip])[None, :]
    want, got = _run_both(cpT, nuT, needles, None, None, GR, W=W, mode=mode)
    _assert_cols_equal(want, got)
    assert got[2][0, 0] == 1  # the whole-row run is exact
    assert got[0][0, 1] == 1 and got[1][0, 0] > got[1][0, 1]


def _serve_both(corpora, queries, k, route, **cfg):
    """Raw serving arrays of both packages, compared element for element,
    group by group; asserts the port's finalize route."""
    port, ref = corpora
    before = dict(tbatch.FINALIZE_ROUTES)
    pm = [tm.Matcher.from_query(q, Config(**cfg)) for q in queries]
    pending = tm._dispatch_batch_groups(pm, port, Config(**cfg), k)
    jms = [jm.Matcher.from_query(q, JConfig(**cfg)) for q in queries]
    jpending, _ = jm._dispatch_batch_groups(jms, ref, JConfig(**cfg), k)
    assert len(pending) == len(jpending)
    outs = []
    for (got, _ready, members), (want, jmembers) in zip(pending, jpending):
        assert members == jmembers
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        outs.append(got.numpy())
    if route is not None:
        taken = {r for r, c in tbatch.FINALIZE_ROUTES.items()
                 if c > before[r]}
        assert taken == {route}, taken
    return outs


@pytest.fixture(scope="module")
def partial():
    hay = datagen.partial_match_corpus(median_length=24, num_samples=4500,
                                       seed=7)
    hay += ["dead", "beef", "Fade", "bead", "fade", "dead/beef"]
    return hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)


@pytest.mark.parametrize("mode", MODES)
def test_literal_serving_arrays(partial, mode):
    """One literal batch per mode: stage 1 at T=0, group flags, the
    in-place colstream flow in key-emit mode and the capped finalize."""
    _hay, port, ref = partial
    pre, post = MODE_PREFIX[mode]
    queries = [pre + nd + post for nd in ("dead", "beef", "Fade", "bead")]
    outs = _serve_both((port, ref), queries, 40, None)
    assert sum(int(o[:, 0, 0].sum()) for o in outs) > 0


def test_literal_typo_budget_ignored(partial):
    """A literal query ignores max_typos (stage 1 runs at T=0), and
    max_typos=None (no prefilter) still takes the group flags."""
    _hay, port, ref = partial
    for typos in (3, None):
        outs = _serve_both((port, ref), ["'dead", "'beef"], 40, "capped",
                           max_typos=typos)
        assert outs[0][0, 0, 0] > 0


def test_literal_full_sort_and_empty(partial):
    """A window past half the groups takes the full sort; a literal no
    row contains leaves the all-zero result."""
    _hay, port, ref = partial
    _serve_both((port, ref), ["'e", "'d"], 2048, "full")
    out, = _serve_both((port, ref), ["'~~", "'@@"], 40, None)
    assert not out.any()


@pytest.mark.parametrize("matching", [Matching.EXACT, Matching.PREFIX,
                                      Matching.SUFFIX, Matching.SUBSTRING])
def test_literal_topk_parity(matching):
    """match_topk_batch with Config(matching=...) against the reference's
    match_topk_batch and its host oracle."""
    from frizbee_tpu.config import Matching as JMatching
    from frizbee_tpu.matcher import Matcher as JMatcher

    hay = datagen.partial_match_corpus(median_length=12, num_samples=2500,
                                       seed=5)
    hay += ["dead", "Dead", "xdead", "deadx", "dead/Beef", "de"]
    queries = ["dead", "Dead", "beef"]
    k = 25
    corpus = pack_corpus(hay, device="cpu")
    ref_corpus = j_pack(hay, unicode=False)
    jcfg = JConfig(matching=JMatching[matching.name])
    got = match_topk_batch(queries, corpus, Config(matching=matching), k=k)
    want = jm.match_topk_batch(queries, ref_corpus, jcfg, k=k)
    assert got[0][0] > 0
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0], q
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
        oracle = JMatcher.from_query(q, jcfg, use_device=False).match_arrays(
            ref_corpus)
        assert g[0] == len(oracle[0])
        for a, b in zip(g[1:], oracle):
            np.testing.assert_array_equal(a, b[:k])


@pytest.mark.parametrize("needle,ok", [("d" * 16, True), ("d" * 17, False)])
def test_literal_needle_length_gate(needle, ok):
    """Literal needles of up to 16 bytes take the column-stream literal
    kernel; longer ones (``ok`` False: refused before the generic
    pipelines were ported) take the literal pipeline. Both equal the
    reference's device path."""
    before = dict(tbatch.GENERIC_ROUTES)
    m = Matcher.from_query("^" + needle)
    hay = ["d" * 20, "abc"]
    got = m.match_arrays(pack_corpus(hay, device="cpu"))
    assert list(got[0]) == [0]
    want = jm.Matcher.from_query("^" + needle).match_arrays(hay)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (tbatch.GENERIC_ROUTES["literal_fast"]
            == before["literal_fast"] + (not ok))


def test_literal_overflow_guard_matches_reference():
    """The literal u16 overflow guard counts needle bytes with the
    literal per-char bonus, as the reference's LiteralEngine does."""
    big = dict(match_score=900, matching_case_bonus=300)
    for n in (40, 60, 80):
        needle = "a" * n
        cfg = Config(matching=Matching.SUBSTRING, scoring=Scoring(**big))
        jcfg = JConfig(scoring=JScoring(**big))
        try:
            JLiteralEngine(needle, jcfg)
            ref_ok = True
        except ValueError:
            ref_ok = False
        if ref_ok:
            LiteralEngine(needle, cfg)
        else:
            with pytest.raises(ValueError, match="overflow"):
                LiteralEngine(needle, cfg)
    assert not ref_ok  # the longest needle overflows
