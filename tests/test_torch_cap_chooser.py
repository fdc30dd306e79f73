"""The finalize-cap chooser's exact float32 counts and the vectorised need
matrix, each held to a plain twin of the int32 arithmetic they replace,
and the bucket's cached plane copy."""

from types import SimpleNamespace

import numpy as np
import pytest

from frizbee_tpu_torch import Config, match_topk_batch, pack_corpus
from frizbee_tpu_torch import matcher as tm
from frizbee_tpu_torch.corpus import PackedBucket
from frizbee_tpu_torch.ops.presence import PLANES, needle_need_matrix_np


def need_matrix_twin(needles_q):
    """The per-query bincount loop the vectorised need matrix replaced."""
    Q, n2 = needles_q.shape
    n = n2 // 2

    def fold(v):
        upper = (v >= 0x41) & (v <= 0x5A)
        return np.where(upper, v + 0x20, v) & 127

    ob, fb = fold(needles_q[:, :n].copy()), fold(needles_q[:, n:].copy())
    eq = ob == fb
    counts = np.zeros((Q, 128), np.int32)
    for q in range(Q):
        counts[q] = np.bincount(ob[q][eq[q]], minlength=128)[:128]
    planes = [(counts > k).astype(np.int8) for k in range(PLANES)]
    need_q = np.concatenate(planes, axis=1)
    return need_q.T, need_q.astype(np.int32).sum(axis=1)


def finalize_cap_twin(corpus, pattern_needles, fetch_rows):
    """The chooser as it was: an int32 cast of every bucket's planes and
    NumPy's integer matmul, pattern by pattern."""
    if not pattern_needles:
        return None
    needs = [(need_matrix_twin(nd), t) for nd, t in pattern_needles]
    Q = pattern_needles[0][0].shape[0]
    alive_tot = np.zeros(Q, np.int64)
    n_gtot = 0
    for b in corpus.buckets:
        blk = b.host_blk_bits().astype(np.int32)
        n_g = blk.shape[0]
        n_gtot += n_g
        if b.width <= 1024:
            mask = np.ones((n_g, Q), bool)
            for (need, tot), typos in needs:
                hits = blk @ need.astype(np.int32)
                mask &= hits >= (tot - typos)[None, :]
            alive_tot += mask.sum(axis=0)
        else:
            alive_tot += n_g
    tm.SERVING_COUNTS["alive_pairs"] += int(alive_tot.sum())
    tm.SERVING_COUNTS["cap_pairs"] += n_gtot * Q
    min_blocks = min(-(-fetch_rows // tm.GROUP_ROWS) + 1, n_gtot)
    if min_blocks >= -(-n_gtot // 2):
        return None
    for div in (4, 2):
        cap = max(-(-n_gtot // div), min_blocks)
        if np.all(alive_tot <= cap):
            return int(cap), Q, None
    if n_gtot < tm.MIXED_FINALIZE_MIN_GROUPS:
        return None
    cap = max(-(-n_gtot // 2), min_blocks)
    fit = alive_tot <= cap
    gran = 8 if Q > 8 else 1
    n_sel = (int(fit.sum()) // gran) * gran
    if n_sel == 0:
        return None
    return int(cap), n_sel, np.argsort(~fit, kind="stable")


def random_needles(rng, Q, n, unicode=False):
    """(Q, 2n) int32 orig + flip units over a small alphabet, so units
    repeat past PLANES (query 0 opens with PLANES + 1 of one letter):
    letters of both cases flip case, and some units flip to a unit of
    another fold-bit, which the need matrix skips; under ``unicode``
    some units are codepoints past 0xFF."""
    alphabet = np.array([ord(c) for c in "aAbBcdeZz/_.-09"], np.int32)
    orig = rng.choice(alphabet, (Q, n))
    if unicode:
        orig = np.where(rng.random((Q, n)) < 0.3,
                        rng.integers(0x100, 0x3000, (Q, n)), orig)
    lower = (orig >= 0x61) & (orig <= 0x7A)
    upper = (orig >= 0x41) & (orig <= 0x5A)
    flip = np.where(lower, orig - 0x20, np.where(upper, orig + 0x20, orig))
    apart = rng.random((Q, n)) < 0.2
    flip = np.where(apart, orig + rng.integers(1, 127, (Q, n)), flip)
    if not unicode:
        flip &= 0xFF
    orig[0, :PLANES + 1], flip[0, :PLANES + 1] = ord("a"), ord("A")
    return np.concatenate([orig, flip], axis=1).astype(np.int32)


@pytest.mark.parametrize("Q,n,unicode", [
    (1, 1, False), (4, 7, False), (32, 16, False), (3, 64, False),
    (5, 12, True), (32, 40, True),
])
def test_need_matrix_matches_per_query_loop(Q, n, unicode):
    rng = np.random.default_rng(Q * 1000 + n)
    for _ in range(5):
        nd = random_needles(rng, Q, n, unicode)
        got_need, got_tot = needle_need_matrix_np(nd)
        want_need, want_tot = need_matrix_twin(nd)
        assert got_need.dtype == want_need.dtype == np.int8
        assert got_need.shape == want_need.shape == (PLANES * 128, Q)
        np.testing.assert_array_equal(got_need, want_need)
        assert got_tot.dtype == want_tot.dtype
        np.testing.assert_array_equal(got_tot, want_tot)
        # the draws reach the last plane, and skip units that fold apart
        assert n <= PLANES or want_need[(PLANES - 1) * 128:].any()
        assert n < 4 or (want_tot < n).any()


def random_corpus(rng, density):
    """Buckets of random 0/1 group planes (widths 16-2048, one empty):
    ``SimpleNamespace(buckets=...)`` is all the chooser reads."""
    buckets = []
    for width, n_g in ((16, rng.integers(3, 12)), (32, 0),
                       (128, rng.integers(10, 40)),
                       (1024, rng.integers(5, 20)),
                       (2048, rng.integers(1, 4))):
        b = PackedBucket(width=width, indices=np.zeros(0, np.int64),
                         cp=np.zeros((0, width), np.int8),
                         n_units=np.zeros(0, np.int32),
                         n_bytes=np.zeros(0, np.int32), device="cpu")
        d = rng.uniform(*density, (int(n_g), 1))
        b._keep_host_planes(
            (rng.random((int(n_g), PLANES * 128)) < d).astype(np.int8))
        buckets.append(b)
    return SimpleNamespace(buckets=buckets)


def tier(result, n_gtot, fetch_rows):
    if result is None:
        return "none"
    cap, _n_sel, perm = result
    if perm is not None:
        return "mixed"
    min_blocks = min(-(-fetch_rows // tm.GROUP_ROWS) + 1, n_gtot)
    return "quarter" if cap == max(-(-n_gtot // 4), min_blocks) else "half"


@pytest.mark.parametrize("Q,want_tier", [
    (Q, t) for Q in (1, 4, 32) for t in ("none", "quarter", "half", "mixed")
    # one query alone takes the half tier whenever it fits half the groups
    if not (Q == 1 and t == "mixed")
])
def test_finalize_cap_matches_int32_twin(monkeypatch, Q, want_tier):
    """One, two and three contributing patterns at typos 0-3, each drawn
    (plane density, needle lengths, fetch rows) until the twin takes the
    wanted tier: the same cap, n_sel and perm, and the same growth of the
    chooser's serving counts."""
    if want_tier == "mixed":
        monkeypatch.setattr(tm, "MIXED_FINALIZE_MIN_GROUPS", 0)
    counts = dict.fromkeys(tm.SERVING_COUNTS, 0)
    monkeypatch.setattr(tm, "SERVING_COUNTS", counts)
    rng = np.random.default_rng(Q * 31 + len(want_tier))
    for n_pat in (1, 2, 3):
        for typos in range(4):
            for _draw in range(2000):
                lo = rng.uniform(0, 1)
                corpus = random_corpus(rng, (lo, rng.uniform(lo, 1)))
                n_gtot = sum(b.host_blk_bits().shape[0]
                             for b in corpus.buckets)
                fetch = int(np.exp(rng.uniform(0, np.log(40_000))))
                entries = [
                    (random_needles(rng, Q, int(rng.integers(1, 17))),
                     typos if p == 0 else int(rng.integers(0, 4)))
                    for p in range(n_pat)
                ]
                before = dict(counts)
                want = finalize_cap_twin(corpus, entries, fetch)
                if tier(want, n_gtot, fetch) == want_tier:
                    break
            else:
                pytest.fail(f"no draw reached the {want_tier} tier")
            twin_delta = {k: counts[k] - before[k] for k in counts}
            before = dict(counts)
            got = tm._colstream_finalize_cap(corpus, entries, fetch)
            assert {k: counts[k] - before[k] for k in counts} == twin_delta
            if want is None:
                assert got is None
                continue
            assert got[:2] == want[:2]
            if want[2] is None:
                assert got[2] is None
            else:
                np.testing.assert_array_equal(got[2], want[2])


def test_cached_planes_built_once_and_reused(monkeypatch):
    """Two batched calls on one corpus count from the same float32 copy
    of each bucket's planes; a bucket wider than 1024 keeps none."""
    rng = np.random.default_rng(5)
    hay = ["".join(rng.choice(list("abcdefgh/_"), int(k)))
           for k in rng.integers(3, 100, 3000)]
    corpus = pack_corpus(hay, device="cpu")
    reads = []
    real = PackedBucket.host_blk_planes

    def spy(self):
        planes = real(self)
        reads.append((id(self), planes))
        return planes

    monkeypatch.setattr(PackedBucket, "host_blk_planes", spy)
    queries = ["abc", "hag", "b/a", "ddd"]
    match_topk_batch(queries, corpus, Config(max_typos=0), k=8)
    first = {id(b): b.host_blk_planes() for b in corpus.buckets}
    assert len(first) > 1 and reads
    for b in corpus.buckets:
        planes = first[id(b)]
        assert planes.dtype == np.float32 and planes.flags.c_contiguous
        np.testing.assert_array_equal(planes, b.host_blk_bits())
    reads.clear()
    match_topk_batch(queries[::-1], corpus, Config(max_typos=0), k=8)
    assert reads and all(p is first[key] for key, p in reads)
    assert all(b.host_blk_planes() is first[id(b)] for b in corpus.buckets)

    hay += ["".join(rng.choice(list("uvwxyz"), int(k)))
            for k in rng.integers(1100, 1400, 1200)]
    wide = pack_corpus(hay, bucket_widths=(128, 2048), device="cpu")
    assert [b.width for b in wide.buckets] == [128, 2048]
    assert wide.buckets[1].host_blk_planes() is None
    assert wide.buckets[1].host_blk_bits().shape[0] == 2
    assert wide.buckets[0].host_blk_planes().dtype == np.float32
