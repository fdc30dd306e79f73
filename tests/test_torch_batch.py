"""The port's (Q, 1 + k, 2) serving array against frizbee_tpu's
``fused_match_sorted_batch`` (Pallas in interpret mode), route by route:
capped, mixed, broad tournament, full sort, per-query in-body sort and
the empty batch. Both arrays come from each package's own batch
dispatcher over the same queries and corpus, and are compared element
for element, sentinel rows included. Each test asserts which finalize
route the port took."""

import numpy as np
import pytest
import torch

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu_torch import datagen
from frizbee_tpu_torch.config import Config
from frizbee_tpu_torch.corpus import pack_corpus


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def partial():
    hay = datagen.partial_match_corpus(median_length=24, num_samples=4500,
                                       seed=7)
    return hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)


def _serve_both(corpora, queries, k, route, **cfg):
    """Raw serving arrays of both packages; asserts the port's route."""
    _hay, port, ref = corpora
    before = dict(tbatch.FINALIZE_ROUTES)
    pm = [tm.Matcher.from_query(q, Config(**cfg)) for q in queries]
    pending = tm._dispatch_batch_groups(pm, port, Config(**cfg), k)
    jms = [jm.Matcher.from_query(q, JConfig(**cfg)) for q in queries]
    jpending, _ = jm._dispatch_batch_groups(jms, ref, JConfig(**cfg), k)
    assert len(pending) == len(jpending) == 1
    got, _ready, members = pending[0]
    want, jmembers = jpending[0]
    assert members == jmembers
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if route is not None:
        taken = {r for r, c in tbatch.FINALIZE_ROUTES.items()
                 if c > before[r]}
        assert taken == {route}, taken
    return got.numpy()


@pytest.mark.parametrize("typos", [0, 1, 2])
def test_capped_route(partial, typos):
    out = _serve_both(
        partial, ["deadbeef", "feedbead", "badcafes", "deaddead"], 40,
        "capped", max_typos=typos,
    )
    assert out[0, 0, 0] > 0


def test_full_sort_route(partial):
    """A window past half the groups leaves no capped tier, and the
    tournament gate fails: the full per-query sort."""
    out = _serve_both(partial, ["deadbeef", "beefdead"], 2048, "full")
    assert out[0, 0, 0] > 40


def test_no_prefilter_route(partial):
    """No stage-1 flags (max_typos=None): every group runs."""
    _serve_both(partial, ["dead", "beef"], 40, None, max_typos=None)


def test_empty_batch(partial):
    """No query has a stage-1 survivor: the all-zero result."""
    out = _serve_both(partial, ["~~~~", "@@@@"], 40, None)
    assert not out.any()


def test_in_body_sort_route(partial, monkeypatch):
    """Past the batched-sort budget each query's keys sort on their own
    (shape unique to this test so the reference traces it anew)."""
    monkeypatch.setattr(jbatch, "SORT_BODY_BUDGET", 1 << 10)
    monkeypatch.setattr(tbatch, "SORT_BODY_BUDGET", 1 << 10)
    _serve_both(partial, ["deadbeef", "feedbead"], 37, "presorted")


def test_broad_tournament_route():
    """All rows match and k is small: no capped tier below the mixed
    gate, so the block-min tournament serves the top-k."""
    hay = datagen.all_match_corpus(median_length=24, num_samples=10300,
                                   seed=77)
    out = _serve_both(
        (hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)),
        ["deadbeef", "feedbead"], 32, "broad",
    )
    assert out[0, 0, 0] == len(hay)


def test_mixed_route(monkeypatch):
    """A selective and a broad needle in one batch split at n_sel: the
    selective one takes the capped gather, the broad one the tournament
    or full sort (group-count gate lowered in both packages)."""
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
    corpora = (hay, pack_corpus(hay, device="cpu"),
               j_pack(hay, unicode=False))
    _serve_both(corpora, ["beef", "0123"], 40, "mixed")
    # broad-first input order exercises the selective-first reorder
    _serve_both(corpora, ["0123", "beef"], 40, "mixed")


def test_key_pack_and_decode_match_reference():
    """pack_keys / _decode_keys against the reference's _keys_from_cols
    and _decode_keys on random columns (incl. unmatched and padding rows,
    saturated scores, the int32 sign bit of meta), and the colstream
    kernel's 5-column mode packed on the host equals its key-emit mode."""
    import jax.numpy as jnp

    from frizbee_tpu_torch.ops import colstream as tcs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars

    rng = np.random.default_rng(17)
    B, idx_bits = 5000, 13
    cols = [
        rng.integers(0, 2, B), rng.integers(0, 0x10000, B),
        rng.integers(0, 2, B), rng.integers(0, 0x5000, B),
        rng.integers(0, 2, B),
    ]
    idx = rng.permutation(B).astype(np.int32)
    idx[rng.random(B) < 0.1] = -1
    tk = tcs.pack_keys(
        *(torch.from_numpy(c.astype(np.int32)) for c in cols),
        torch.from_numpy(idx), idx_bits,
    )
    tc = (tk != tcs.INT64_MAX).sum()
    jk, jc = jbatch._keys_from_cols(
        *(jnp.asarray(c > 0) if i in (0, 2, 4) else jnp.asarray(c, jnp.int32)
          for i, c in enumerate(cols)),
        jnp.asarray(idx), idx_bits,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(tc) == int(jc)
    keys = torch.sort(tk).values
    mask = (1 << idx_bits) - 1
    ti, tmeta = tbatch._decode_keys(keys, idx_bits, mask)
    import jax

    with jax.enable_x64(True):  # int64 keys, as the reference builds them
        ji, jmeta = jbatch._decode_keys(jnp.asarray(keys.numpy()),
                                        idx_bits, mask)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))

    # 5-column mode + host packing == key-emit mode
    W, nG = 32, 2
    cp = rng.integers(97, 101, (nG * 1024, W)).astype(np.int8)
    nu = rng.integers(0, W + 1, nG * 1024).astype(np.int32)
    cpT = torch.from_numpy(np.ascontiguousarray(
        cp.reshape(nG, 1024, W).transpose(0, 2, 1)).reshape(nG * W, 8, 128))
    nuT = torch.from_numpy(nu.reshape(nG * 8, 128))
    idxT = torch.from_numpy(rng.permutation(nG * 1024).astype(np.int32))
    scal = pack_needle_scalars(
        torch.tensor([[97, 98, 99, 65, 66, 67]], dtype=torch.int32),
        nG * 1024)
    kw = dict(W=W, n=3, scoring=DEFAULT_SCORING, idx_bits=11)
    five = tcs.match_units_colstream(cpT, nuT, scal, **kw)
    keyed = tcs.match_units_colstream(cpT, nuT, scal, None, idxT, **kw)
    packed = tcs.pack_keys(*(c[0] for c in five), idxT, 11)
    assert torch.equal(packed, keyed[0])
    assert int((keyed != tcs.INT64_MAX).sum()) > 0
