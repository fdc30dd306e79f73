"""The port's corpus packing, colstream layout and stage-1 presence
against frizbee_tpu's, element for element (zero tolerance), plus the
state carried across: a corpus saved by frizbee_tpu loads in the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu import datagen as jdatagen
from frizbee_tpu.corpus import Corpus as JCorpus
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.ops.presence import (
    needle_need_matrix as j_need,
    presence_bits,
    presence_mask,
)
from frizbee_tpu_torch import datagen
from frizbee_tpu_torch.corpus import Corpus, pack_corpus, resolve_device
from frizbee_tpu_torch.ops.presence import (
    needle_need_matrix,
    needle_need_matrix_np,
    presence_hits,
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hay():
    h = datagen.partial_match_corpus(median_length=24, num_samples=2600,
                                     seed=5)
    # a second length population -> several buckets, non-contiguous rows
    h += [x * 5 for x in datagen.partial_match_corpus(
        median_length=16, num_samples=1400, seed=6)]
    h += ["", "DeadBeef", "dead_beef", "x" * 300]
    return h


def _assert_same_corpus(port, ref):
    assert len(port.buckets) == len(ref.buckets) >= 2
    for pb, rb in zip(port.buckets, ref.buckets):
        assert pb.width == rb.width
        np.testing.assert_array_equal(pb.indices, rb.indices)
        np.testing.assert_array_equal(
            pb.cp.astype(np.int32) & 0xFF, rb.cp.astype(np.int32) & 0xFF
        )
        np.testing.assert_array_equal(pb.n_units, rb.n_units)
        np.testing.assert_array_equal(pb.n_bytes, rb.n_bytes)
    np.testing.assert_array_equal(port.xl_indices, ref.xl_indices)


def test_pack_matches_reference(hay):
    _assert_same_corpus(pack_corpus(hay, device="cpu"),
                        j_pack(hay, unicode=False))


def test_colstream_layout_and_bits8(hay):
    """cpT/nuT/idxT/blk_bits in the same cluster order, and the per-row
    bits8 planes equal presence_bits(presence_mask(...))."""
    port = pack_corpus(hay, device="cpu")
    ref = j_pack(hay, unicode=False)
    for pb, rb in zip(port.buckets, ref.buckets):
        got = pb.device_arrays_colstream()
        want = rb.device_arrays_colstream()
        np.testing.assert_array_equal(
            got[0].numpy().astype(np.int32) & 0xFF,
            np.asarray(want[0]).astype(np.int32) & 0xFF,
        )
        for i in (1, 2, 3):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(pb.host_blk_bits(), rb.host_blk_bits())
        bits8 = pb.device_presence_bits()
        cp_j = jnp.asarray(rb.cp)
        nu_j = jnp.asarray(rb.n_units.astype(np.int32)[:, None])
        np.testing.assert_array_equal(
            bits8.numpy(), np.asarray(presence_bits(presence_mask(cp_j, nu_j)))
        )


def _needles(queries):
    out = []
    for q in queries:
        o = np.frombuffer(q.encode(), np.uint8).astype(np.int32)
        f = np.where((o >= 97) & (o <= 122), o - 32,
                     np.where((o >= 65) & (o <= 90), o + 32, o))
        out.append(np.concatenate([o, f]))
    return np.stack(out)


@pytest.mark.parametrize("T", [0, 1, 2, 3])
def test_need_matrix_and_group_flags(hay, T):
    """Need matrices (torch and NumPy twins) and the per-group flags
    (Q > 1) against the reference's matmul over its own planes."""
    nq = _needles(["deadbeef", "eeeebbbb", "fadedbed", "qqqqzzzz"])
    need, tot = needle_need_matrix(torch.from_numpy(nq))
    need_j, tot_j = j_need(jnp.asarray(nq))
    np.testing.assert_array_equal(need.numpy(), np.asarray(need_j))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_j))
    need_np, tot_np = needle_need_matrix_np(nq)
    np.testing.assert_array_equal(need_np, np.asarray(need_j))
    np.testing.assert_array_equal(tot_np, np.asarray(tot_j))

    port = pack_corpus(hay, device="cpu")
    ref = j_pack(hay, unicode=False)
    seen = []
    for pb, rb in zip(port.buckets, ref.buckets):
        blk = pb.device_arrays_colstream()[3]
        got = (presence_hits(blk, need) >= (tot - T)[None, :]).T
        hits_j = jnp.dot(
            jnp.asarray(rb.device_arrays_colstream()[3]), need_j,
            preferred_element_type=jnp.int32,
        )
        want = (np.asarray(hits_j) >= (np.asarray(tot_j) - T)[None, :]).T
        np.testing.assert_array_equal(got.numpy(), want)
        seen.append(want.ravel())
    seen = np.concatenate(seen)
    assert seen.any() and not seen.all()


def test_corpus_load_of_reference_save(hay, tmp_path):
    """State carried across: an npz written by frizbee_tpu's Corpus.save
    loads as the same packed corpus (and from_numpy does the same from
    in-memory bucket arrays)."""
    ref = j_pack(hay, unicode=False)
    path = str(tmp_path / "corpus.bin")
    ref.save(path)
    loaded = Corpus.load(path, device="cpu")
    assert loaded.haystacks == hay
    _assert_same_corpus(loaded, JCorpus.load(path))
    direct = Corpus.from_numpy(
        ref.haystacks,
        [(b.width, b.indices, b.cp, b.n_units, b.n_bytes)
         for b in ref.buckets],
        ref.xl_indices, device="cpu",
    )
    _assert_same_corpus(direct, ref)


def test_datagen_matches_reference():
    for fn, kw in (
        ("partial_match_corpus", dict(median_length=32, num_samples=500)),
        ("all_match_corpus", dict(median_length=20, num_samples=300)),
        ("no_match_corpus", dict(median_length=16, num_samples=300,
                                 partial=0.3)),
        ("chromium_like_corpus", dict(num_samples=300)),
    ):
        assert getattr(datagen, fn)(seed=11, **kw) == getattr(
            jdatagen, fn)(seed=11, **kw), fn


def test_default_device_is_the_card(monkeypatch):
    """With no device given the entry points run on the card; a host
    without one raises instead of drifting to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_corpus(["abc", "def"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_unicode_corpus_packs_on_cpu():
    """A unicode corpus packs codepoint units on the CPU, with UTF-8 byte
    counts beside the unit counts."""
    c = pack_corpus(["héllo", "€𐍈", ""], unicode=True, device="cpu")
    assert c.unicode and c.device == torch.device("cpu")
    (b,) = c.buckets
    assert b.cp.dtype == np.int32 and b.unicode
    assert b.n_units[:3].tolist() == [5, 2, 0]
    assert b.n_bytes[:3].tolist() == [6, 7, 0]
    assert b.cp[1, :2].tolist() == [0x20AC, 0x10348]
