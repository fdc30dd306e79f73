"""Multi-pattern and negated queries in the port against frizbee_tpu: the
(Q, 1 + k, 2) arrays of both packages' ``_dispatch_batch_groups`` (the
reference's ``_fused_multi_batch_fast`` with Pallas in interpret mode)
compared element for element, sentinel rows included, over every
finalize route and a codepoint corpus; the decoded ``match_topk_batch``
results against the reference's; and the multi flow's predicates, key
packing and finalize-cap chooser against the reference's over a grid.

Inputs are made from a seed and handed to both packages; every
comparison has zero tolerance (integer arrays, element for element)."""

import itertools

import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.matcher import match_topk_batch as j_topk
from frizbee_tpu_torch import Config, datagen, match_topk_batch
from frizbee_tpu_torch.corpus import pack_corpus
from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _corpora(hay, unicode=False):
    return (hay, pack_corpus(hay, unicode=unicode, device="cpu"),
            j_pack(hay, unicode=unicode))


@pytest.fixture(scope="module")
def partial():
    return _corpora(datagen.partial_match_corpus(
        median_length=24, num_samples=4500, seed=7))


@pytest.fixture(scope="module")
def arabic():
    return _corpora(datagen.unicode_corpus(
        "arabic", num_samples=3000, median_units=18, needle="إن", seed=9,
    ), unicode=True)


def _serve_both(corpora, queries, k, routes=None, **cfg):
    """Raw serving arrays of both packages, group by group; asserts the
    multi flow served every group and, given ``routes``, the port's
    finalize routes. Returns the port's arrays."""
    _hay, port, ref = corpora
    before = dict(tbatch.FINALIZE_ROUTES)
    flows = dict(tbatch.COLSTREAM_FLOWS)
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
    assert tbatch.COLSTREAM_FLOWS["multi"] - flows["multi"] == len(pending)
    assert tbatch.COLSTREAM_FLOWS["single"] == flows["single"]
    if routes is not None:
        taken = {r for r, c in tbatch.FINALIZE_ROUTES.items()
                 if c > before[r]}
        assert taken == set(routes), taken
    return outs


def _topk_both(corpora, queries, k, **cfg):
    _hay, port, ref = corpora
    got = match_topk_batch(queries, port, Config(**cfg), k=k)
    want = j_topk(queries, ref, JConfig(**cfg), k=k)
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0], q
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    return got


# the reference's own multi-pattern serving sets (tests/test_batch_fast.py)
REFERENCE_SETS = [
    (["dead beef", "dead !beef", "'dead beef", "^de ad", "!dead !beef"], {}),
    (["dead beef", "daed beef"], {"max_typos": 1}),
]


@pytest.mark.parametrize("queries,cfg", REFERENCE_SETS)
def test_reference_query_sets(partial, queries, cfg):
    outs = _serve_both(partial, queries, 40, **cfg)
    assert any(o[:, 0, 0].max() > 0 for o in outs)
    _topk_both(partial, queries, 40, **cfg)


def test_reference_topk_set(partial):
    """Two 2-pattern queries of one shape group, decoded top-k."""
    got = _topk_both(partial, ["dead beef", "ea be"], 40)
    assert got[1][0] > 40


def test_all_negated_query(partial):
    """No contributing pattern: no group flags, no capped tier, every
    row that no atom matches is a match."""
    (out,) = _serve_both(partial, ["!dead !beef"], 40, routes={"full"})
    assert out[0, 0, 0] > 4000


def test_single_negated_query(partial):
    (out,) = _serve_both(partial, ["!dead"], 16, routes={"broad"})
    assert 0 < out[0, 0, 0] < len(partial[0])
    _topk_both(partial, ["!dead", "!beef"], 16)


def test_capped_route(partial):
    (out,) = _serve_both(partial, ["dead beef", "feed bead"], 40,
                         routes={"capped"})
    assert out[0, 0, 0] > 0


def test_full_sort_route(partial):
    """A window past half the groups: the full per-query sort (two
    groups: a fuzzy pair and a fuzzy atom with a negated one)."""
    outs = _serve_both(partial, ["dead beef", "fade !bad"], 2048,
                       routes={"full"})
    assert len(outs) == 2 and outs[0][0, 0, 0] > 40


def test_broad_tournament_route():
    """Every row matches both atoms and k is small: the tournament."""
    hay = datagen.all_match_corpus(median_length=24, num_samples=10300,
                                   seed=77)
    (out,) = _serve_both(_corpora(hay), ["dead beef"], 32,
                         routes={"broad"})
    assert out[0, 0, 0] == len(hay)


def test_mixed_route(monkeypatch):
    """A selective and a broad 2-pattern query in one batch split at
    n_sel (group-count gate lowered in both packages)."""
    monkeypatch.setattr(jm, "MIXED_FINALIZE_MIN_GROUPS", 0)
    monkeypatch.setattr(tm, "MIXED_FINALIZE_MIN_GROUPS", 0)
    rng = np.random.default_rng(21)
    hay = [
        "".join(rng.choice(list("abcdef"), 20)) + "0123"
        for _ in range(4000)
    ] + [
        "".join(rng.choice(list("uvwxyz"), 20)) + "0123"
        for _ in range(12000)
    ]
    corpora = _corpora(hay)
    _serve_both(corpora, ["01 23", "be ef"], 40, routes={"mixed"})
    _topk_both(corpora, ["be ef", "01 23"], 40)


def test_arabic_multi_batches(arabic):
    """Codepoint units: a fuzzy pair and a negated one (the reference's
    unicode multi-pattern set), plus a literal atom."""
    _serve_both(arabic, ["إن ن", "إن !م"], 40)
    _serve_both(arabic, ["إن 'ما"], 40)
    _topk_both(arabic, ["إن ن", "إن !م", "إن 'ما"], 40)


def test_in_body_sort_route(partial, monkeypatch):
    """Past the batched-sort budget each query's keys sort on their own
    (a fetch window unique to this test so the reference traces anew)."""
    monkeypatch.setattr(jbatch, "SORT_BODY_BUDGET", 1 << 10)
    monkeypatch.setattr(tbatch, "SORT_BODY_BUDGET", 1 << 10)
    _serve_both(partial, ["dead beef", "feed bead"], 37,
                routes={"presorted"})


FUZZY = "fuzzy"
MODES = [FUZZY, "exact", "prefix", "suffix", "substring"]


def _statics(typos, nopre, neg, mode, nbl=4):
    return (typos, nopre, neg, tuple(DEFAULT_SCORING), mode, nbl)


GRID = list(itertools.product(
    [0, 1, 3, 4, 9], [False, True], [False, True], MODES,
    [0, 1, 3, 4, 16, 17, 64],
))


@pytest.mark.parametrize("mode", MODES)
def test_predicates_match_reference(mode):
    """colstream_eligible_all (one pattern and pairs) and
    _pattern_s1_contributes over typos x no_prefilter x negated x length."""
    grid = [g for g in GRID if g[3] == mode]
    for typos, nopre, neg, m, ln in grid:
        st = _statics(typos, nopre, neg, m)
        assert (tbatch._pattern_s1_contributes(st, ln)
                == jbatch._pattern_s1_contributes(st, ln)), (st, ln)
        assert (tbatch.colstream_eligible_all((st,), (ln,))
                == jbatch.colstream_eligible_all((st,), (ln,))), (st, ln)
    rng = np.random.default_rng(5)
    for _ in range(200):
        a, b = (GRID[i] for i in rng.integers(0, len(GRID), 2))
        sts = (_statics(*a[:4]), _statics(*b[:4]))
        lens = (a[4], b[4])
        assert (tbatch.colstream_eligible_all(sts, lens)
                == jbatch.colstream_eligible_all(sts, lens)), (sts, lens)


@pytest.mark.parametrize("idx_bits", [11, 20, 31])
def test_keys_from_cols_match_reference(idx_bits):
    """_keys_from_cols against the reference's on random columns:
    unmatched and padding rows, saturated scores, end columns past 14
    bits, bool and int32 flag columns."""
    import jax.numpy as jnp

    rng = np.random.default_rng(idx_bits)
    B = 4000
    cols = [
        rng.integers(0, 2, B), rng.integers(0, 0x10000, B),
        rng.integers(0, 2, B), rng.integers(0, 0x5000, B),
        rng.integers(0, 2, B),
    ]
    idx = rng.integers(0, 1 << min(idx_bits, 30), B).astype(np.int32)
    idx[rng.random(B) < 0.1] = -1
    jk, jc = jbatch._keys_from_cols(
        *(jnp.asarray(c > 0) if i in (0, 2, 4) else jnp.asarray(c, jnp.int32)
          for i, c in enumerate(cols)),
        jnp.asarray(idx), idx_bits,
    )
    for flags_as_bool in (True, False):
        tk, tc = tbatch._keys_from_cols(
            *(torch.from_numpy(c > 0) if flags_as_bool and i in (0, 2, 4)
              else torch.from_numpy(c.astype(np.int32))
              for i, c in enumerate(cols)),
            torch.from_numpy(idx), idx_bits,
        )
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert int(tc) == int(jc)


def _nd(q):
    o = np.frombuffer(q.encode(), np.uint8).astype(np.int32)
    f = np.where((o >= 97) & (o <= 122), o - 32, o)
    return np.concatenate([o, f])


@pytest.mark.parametrize("fetch", [40, 700, 3000])
def test_multi_entry_finalize_cap_matches_reference(partial, monkeypatch,
                                                   fetch):
    """The host cap chooser over one, two and three contributing patterns
    at several budgets, with the mixed gate open and shut, against the
    reference's; and the dispatcher's entry list (which patterns
    contribute) against the reference's _colstream_blocks_and_cap."""
    _hay, port, ref = partial
    sets = [
        [("dead", 0)], [("dead", 0), ("beef", 0)],
        [("dead", 1), ("beef", 0), ("fa", 0)], [("ab", 0), ("cd", 1)],
    ]
    for gate in (512, 0):
        monkeypatch.setattr(jm, "MIXED_FINALIZE_MIN_GROUPS", gate)
        monkeypatch.setattr(tm, "MIXED_FINALIZE_MIN_GROUPS", gate)
        for pats in sets:
            entries = [
                (np.stack([_nd(q), _nd(q[::-1])]), t) for q, t in pats
            ]
            got = tm._colstream_finalize_cap(port, entries, fetch)
            want = jm._colstream_finalize_cap(ref, entries, fetch)
            if want is None:
                assert got is None
                continue
            assert got[:2] == want[:2]
            assert (got[2] is None) == (want[2] is None)
            if want[2] is not None:
                np.testing.assert_array_equal(got[2], want[2])
    sc = tuple(DEFAULT_SCORING)
    statics = ((0, False, False, sc, FUZZY, 4), (0, False, True, sc, FUZZY, 4),
               (1, False, False, sc, "prefix", 2))
    needles = [np.stack([_nd("dead"), _nd("beef")]),
               np.stack([_nd("cafe"), _nd("face")]),
               np.stack([_nd("de"), _nd("be")])]
    got = tm._colstream_blocks_and_cap(port, statics, [4, 4, 2], needles,
                                       fetch, single=False)
    want = jm._colstream_blocks_and_cap(ref, statics, [4, 4, 2], needles,
                                        fetch, single=False)
    assert got[0] == (want[0] is not None)
    assert got[1] == want[1]
    assert (got[2] is None) == (want[2] is None)
