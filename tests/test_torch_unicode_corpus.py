"""The port's codepoint (unicode) corpus packing, its colstream blocks with
the ctx plane, its row-major operands and stage-1 presence against
frizbee_tpu's, element for element (zero tolerance), plus the state
carried across: a unicode corpus saved by frizbee_tpu loads in the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu.corpus import Corpus as JCorpus
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.ops.presence import (
    needle_need_matrix as j_need,
    presence_bits,
    presence_mask,
)
from frizbee_tpu_torch import datagen
from frizbee_tpu_torch.config import Config, UnicodeMatching
from frizbee_tpu_torch.corpus import Corpus, ctx_plane, pack_corpus
from frizbee_tpu_torch.engine import make_engine
from frizbee_tpu_torch.ops.presence import (
    needle_need_matrix,
    needle_need_matrix_np,
    presence_hits,
)

# 2-byte (é, ل), 3-byte (€, 가), 4-byte (𐍈, 😀) code points, case pairs,
# delimiters, and a row whose fold bin differs from its low byte's
EDGE_ROWS = [
    "", "é", "€𐍈", "inلux", "LEINUX", "Λinux", "l€i€n€u€x", "𐍈linux𐍈",
    "가나다 linux 가나다", "😀" * 40 + "lin😀ux", "ففA", "ÀÉÎõü",
]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hay():
    h = datagen.unicode_corpus("arabic", needle="إن", num_samples=2200,
                               seed=5)
    h += datagen.unicode_corpus("korean", needle="니다", num_samples=1500,
                                seed=6)
    # a wide population (w256) and rows of more than 1024 UTF-8 bytes
    h += [r * 9 for r in datagen.unicode_corpus(
        "korean", needle="니다", num_samples=1100, seed=7)]
    return h + EDGE_ROWS + ["€" * 500, "x" + "😀" * 300 + "y"]


@pytest.fixture(scope="module")
def corpora(hay):
    return pack_corpus(hay, unicode=True, device="cpu"), j_pack(hay,
                                                                unicode=True)


def _assert_same_corpus(port, ref):
    assert port.unicode and ref.unicode
    assert len(port.buckets) == len(ref.buckets) >= 2
    for pb, rb in zip(port.buckets, ref.buckets):
        assert pb.width == rb.width
        assert pb.cp.dtype == np.int32
        np.testing.assert_array_equal(pb.indices, rb.indices)
        np.testing.assert_array_equal(pb.cp, rb.cp)
        np.testing.assert_array_equal(pb.n_units, rb.n_units)
        np.testing.assert_array_equal(pb.n_bytes, rb.n_bytes)
    np.testing.assert_array_equal(port.xl_indices, ref.xl_indices)


def test_pack_matches_reference(corpora):
    port, ref = corpora
    _assert_same_corpus(port, ref)
    assert [b.width for b in port.buckets] == [16, 32, 256, 512]


def test_colstream_blocks_ctx_plane_and_bits8(corpora):
    """cpT/nuT/idxT/blk_bits/ctxT in the same cluster order as the
    reference's, and the per-row bits8 planes equal
    presence_bits(presence_mask(cp)) over the whole codepoints."""
    port, ref = corpora
    for pb, rb in zip(port.buckets, ref.buckets):
        got = pb.device_arrays_colstream()
        want = rb.device_arrays_colstream()
        assert got[0].dtype == torch.int32 and got[4].dtype == torch.int8
        for i in range(5):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(pb.host_blk_bits(), rb.host_blk_bits())
        bits8 = pb.device_presence_bits()
        np.testing.assert_array_equal(
            bits8.numpy(),
            np.asarray(presence_bits(presence_mask(
                jnp.asarray(rb.cp), jnp.asarray(rb.n_units[:, None])))),
        )


def test_presence_folds_whole_codepoints():
    """U+0641 folds to bin 0x41 as a codepoint, not to 'a' (its low byte
    0x41 is an uppercase 'A'): a row of it holds no 'a' presence."""
    port = pack_corpus(["ففف", "aaa"], unicode=True,
                       device="cpu")
    counts = port.buckets[0].presence_counts()
    assert counts[0, 0x41] == 3 and counts[0, 0x61] == 0
    assert counts[1, 0x61] == 3


def test_ctx_plane_layout():
    """ctx_plane against the UTF-8 bytes of each codepoint: upper/delim
    of the lead byte, lower/delim of the last byte, the byte length."""
    chars = "aZ/0é€😀Λ_ ف"
    cp = np.array([ord(c) for c in chars], np.int32)
    got = ctx_plane(cp)
    for c, v in zip(chars, got.tolist()):
        b = c.encode("utf-8")

        def delim(x):
            return x <= 127 and not chr(x).isalnum()

        want = (int(0x41 <= b[0] <= 0x5A) | int(delim(b[0])) << 1
                | int(0x61 <= b[-1] <= 0x7A) << 2 | int(delim(b[-1])) << 3
                | len(b) << 4)
        assert v == want, c


def test_device_arrays_units(corpora):
    port, ref = corpora
    for pb, rb in zip(port.buckets, ref.buckets):
        cp, nu, idx = pb.device_arrays_units()
        want = rb.device_arrays_units()
        assert pb.device_arrays_rowmajor() is pb.device_arrays_units()
        np.testing.assert_array_equal(cp.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(want[1])[:, 0])
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
        with pytest.raises(ValueError, match="no byte matrix"):
            pb.device_arrays_ascii()


def _host_needles(queries):
    cfg = Config(unicode=UnicodeMatching.ALWAYS)
    out = []
    for q in queries:
        o, f, _sc = make_engine(q, cfg)._host_needle()
        out.append(np.concatenate([o, f]))
    return np.stack(out)


@pytest.mark.parametrize("T", [0, 1, 2])
def test_need_matrix_and_group_flags(corpora, T):
    """Need matrices of codepoint needles (a Greek case pair, which folds
    apart, is skipped) and the per-group flags against the reference's
    matmul over its own planes."""
    port, ref = corpora
    nq = _host_needles(["إنما", "니다니다", "λλab", "zzzz"])
    need, tot = needle_need_matrix(torch.from_numpy(nq))
    need_j, tot_j = j_need(jnp.asarray(nq))
    np.testing.assert_array_equal(need.numpy(), np.asarray(need_j))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_j))
    need_np, tot_np = needle_need_matrix_np(nq)
    np.testing.assert_array_equal(need_np, np.asarray(need_j))
    np.testing.assert_array_equal(tot_np, np.asarray(tot_j))
    assert int(tot[2]) == 2  # 'λ'/'Λ' fold apart: only a and b are needed
    seen = []
    for pb, rb in zip(port.buckets, ref.buckets):
        got = (presence_hits(pb.device_arrays_colstream()[3], need)
               >= (tot - T)[None, :]).T
        hits_j = jnp.dot(jnp.asarray(rb.device_arrays_colstream()[3]),
                         need_j, preferred_element_type=jnp.int32)
        want = (np.asarray(hits_j) >= (np.asarray(tot_j) - T)[None, :]).T
        np.testing.assert_array_equal(got.numpy(), want)
        seen.append(want.ravel())
    seen = np.concatenate(seen)
    assert seen.any() and not seen.all()


def test_corpus_load_of_reference_unicode_save(hay, corpora, tmp_path):
    """A unicode npz written by frizbee_tpu's Corpus.save (with its
    per-unit context arrays) loads as the same packed corpus; from_numpy
    does the same from in-memory bucket arrays."""
    _port, ref = corpora
    path = str(tmp_path / "corpus.bin")
    ref.save(path)
    loaded = Corpus.load(path, device="cpu")
    assert loaded.haystacks == hay
    _assert_same_corpus(loaded, JCorpus.load(path))
    direct = Corpus.from_numpy(
        ref.haystacks,
        [(b.width, b.indices, b.cp, b.n_units, b.n_bytes)
         for b in ref.buckets],
        ref.xl_indices, unicode=True, device="cpu",
    )
    _assert_same_corpus(direct, ref)


def test_greedy_risk(corpora):
    """Rows of more than 1024 UTF-8 bytes put a corpus at greedy risk,
    as in the reference; short rows do not."""
    port, ref = corpora
    assert port.greedy_risk() and ref.greedy_risk()
    small = ["가나다", "€" * 300]
    assert not pack_corpus(small, unicode=True, device="cpu").greedy_risk()
    assert not j_pack(small, unicode=True).greedy_risk()
