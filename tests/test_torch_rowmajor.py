"""The row-major route in the port against frizbee_tpu: the plain version
of ``match_units`` (which the CUDA kernel ``csrc/match_units.cu`` is held
against on the card) against the reference's Pallas ``match_units`` in
interpret mode — with its narrow-bucket segment packing and, where
``score_fits_int16`` holds, its int16 lanes, exactly as the reference's
serving path calls it — and row-major batches served by both packages.

Inputs are made with numpy from a seed and handed to both packages.
Every comparison has zero tolerance. Serving arrays are compared on the
count header and the first min(count, k) rows: the reference picks a
survivor capacity tier on the device (1/16, 1/8, 1/4 of a bucket, else
every row) and fills the rows past the count with sentinel decodes or
zero padding depending on the tier, while the port serves every tier in
one flow; no caller reads those rows. Batches that reach the
reference's full-capacity flow compare element for element."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import frizbee_tpu.matcher as jm
import frizbee_tpu.ops.batch as jbatch
import frizbee_tpu.ops.kernels as jk
import frizbee_tpu_torch.matcher as tm
import frizbee_tpu_torch.ops.batch as tbatch
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu_torch import Config, datagen, match_topk_batch
from frizbee_tpu_torch import pack_corpus
from frizbee_tpu_torch.ops import colstream as cs
from frizbee_tpu_torch.ops import kernels as tk
from frizbee_tpu_torch.ops.presence import needle_need_matrix, presence_hits

SCORINGS = [tk.DEFAULT_SCORING, (10, 3, 1, 2, 7, 5, 2, 6, 9)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _needle(rng, n, alphabet=6):
    o = rng.integers(97, 97 + alphabet, n).astype(np.int32)
    o = np.where(rng.random(n) < 0.2, o - 32, o)
    f = np.where(o >= 97, o - 32, o + 32)
    return np.concatenate([o, f])


def _rows(rng, B, W, needle, alphabet=6):
    """Rows of 0..W units: random letters with capitals and '/'
    delimiters, a third of them carrying the needle's units in order
    (some with one unit dropped), so the prefilter passes some rows and
    rejects the rest."""
    n = needle.shape[0] // 2
    cp = rng.integers(97, 97 + alphabet, (B, W)).astype(np.int32)
    cp = np.where(rng.random((B, W)) < 0.2, cp - 32, cp)
    cp = np.where(rng.random((B, W)) < 0.08, 47, cp)
    nu = rng.integers(0, W + 1, B).astype(np.int32)
    for r in np.nonzero(rng.random(B) < 0.35)[0]:
        units = needle[:n].copy()
        if rng.random() < 0.3:
            units = np.delete(units, rng.integers(0, n))
        m = min(len(units), W)
        nu[r] = max(nu[r], m)
        pos = np.sort(rng.choice(nu[r], m, replace=False))
        cp[r, pos] = units[:m]
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    return cp.astype(np.int8), nu


def _reference_cols(cp, nu, needle, count, *, T, no_pre, scoring):
    """The reference's match_units as its serving path runs it: narrow
    buckets packed 128 // W rows per vector, int16 lanes when the score
    bound fits, the count in vector rows. (rows, 8) logical results."""
    W = cp.shape[1]
    n = needle.shape[0] // 2
    cp_k, nu_k, seg, g = jk.pack_rows_for_kernel(
        jnp.asarray(cp), jnp.asarray(nu[:, None]))
    cnt = -(-count // g) if g > 1 else count
    out = jk.match_units(
        cp_k, nu_k, jk.pack_needle_scalars(jnp.asarray(needle), cnt),
        max_typos=T, scoring=scoring, no_prefilter=no_pre,
        int16_lanes=jk.score_fits_int16(scoring, n, W), interpret=True,
        seg=seg,
    )
    return np.asarray(out).reshape(-1, 8)


COLUMN_CASES = [
    (16, 17, 0, False),
    (64, 17, 4, False),
    (128, 17, 8, False),
    (64, 40, 0, False),
    (128, 40, 4, False),
    (128, 64, 8, False),
    (128, 64, 0, False),
    (64, 24, 0, True),
    (32, 5, 8, False),   # needle within the budget: every row matches
    (128, 9, 4, False),  # a short needle past the colstream budget
]

# (W, n, T) at the CUDA kernel's template boundaries: needle ceilings 16,
# 32, 64 (32-bit masks up to 32 units) and the DP-state ceilings 1, 2, 4,
# 8 of the typo budget, on 64 rows of a narrow bucket
BOUNDARY_CASES = [
    (16, 8, 1),
    (32, 8, 2),
    (16, 8, 3),
    (16, 16, 5),
    (32, 17, 8),
    (32, 32, 6),
    (32, 33, 2),
    (32, 64, 7),
]


def _columns_case(W, n, T, B=512):
    """(cp, nu, needle, live count, scoring) of one columns case."""
    rng = np.random.default_rng(W * 100 + n + T)
    needle = _needle(rng, n)
    cp, nu = _rows(rng, B, W, needle)
    return cp, nu, needle, B - 37 * B // 512, SCORINGS[(n + T) % 2]


def _check_columns(W, n, T, no_pre, B):
    cp, nu, needle, count, scoring = _columns_case(W, n, T, B)
    got = tk.match_units(
        torch.from_numpy(cp), torch.from_numpy(nu),
        tk.pack_needle_scalars(torch.from_numpy(needle[None]), count),
        n=n, max_typos=T, scoring=scoring, no_prefilter=no_pre,
    )[0].numpy()
    want = _reference_cols(cp, nu, needle, count, T=T, no_pre=no_pre,
                           scoring=scoring)
    np.testing.assert_array_equal(got[:count], want[:count])
    assert not got[count:].any()
    return got[:count]


@pytest.mark.parametrize("W,n,T,no_pre", COLUMN_CASES)
def test_match_units_columns(W, n, T, no_pre):
    """(B, 8) columns for the live rows, zeros past the count; rows the
    prefilter rejects keep the full-row DP's score, exact and end_col."""
    got = _check_columns(W, n, T, no_pre, 512)
    if n <= W or no_pre:
        assert got[:, 0].any()


@pytest.mark.parametrize("W,n,T", BOUNDARY_CASES)
def test_match_units_template_boundaries(W, n, T):
    """The plain version against the reference at each (needle length,
    typo budget) boundary of the CUDA kernel's instantiations."""
    got = _check_columns(W, n, T, False, 64)
    if n - T <= W:
        assert got[:, 0].any()


@pytest.mark.parametrize("W,n,T,no_pre", COLUMN_CASES + [
    (W, n, T, False) for W, n, T in BOUNDARY_CASES])
def test_prefilter_window_matches_reference(W, n, T, no_pre):
    """``prefilter_window`` (pass 1, shared by the plain version and the
    bound's operation count) decides ``matched`` as the reference's
    column 0 does, and leaves rejected rows their whole byte range."""
    B = 512 if (W, n, T, no_pre) in COLUMN_CASES else 64
    cp, nu, needle, count, scoring = _columns_case(W, n, T, B)
    matched, wstart, wend, n_bytes = tk.prefilter_window(
        torch.from_numpy(cp[:count]), torch.from_numpy(nu[:count]),
        needle[:n].tolist(), needle[n:].tolist(), n=n, T=min(T, n),
        no_prefilter=no_pre,
    )
    want = _reference_cols(cp, nu, needle, count, T=T, no_pre=no_pre,
                           scoring=scoring)
    np.testing.assert_array_equal(matched.numpy(), want[:count, 0] > 0)
    assert torch.equal(n_bytes, torch.clamp(torch.from_numpy(nu[:count]),
                                            max=W))
    rejected = ~matched
    assert not wstart[rejected].any()
    assert torch.equal(wend[rejected], n_bytes[rejected])
    assert ((wstart <= wend) & (wend <= n_bytes)).all()
    cols = tk.window_units(torch.from_numpy(cp[:count]),
                           torch.from_numpy(nu[:count]), wstart, wend)
    assert torch.equal(cols, wend - torch.clamp(wstart - 1, min=0))


@pytest.mark.parametrize("M,ids", [
    (0, "none"),
    (1, "first"),
    (1, "last"),
    (9, "edges"),
])
def test_row_gather_plain_edges(M, ids):
    """The row gather's plain version against numpy indexing: no rows,
    one row, and row ids 0 and R-1."""
    rng = np.random.default_rng(M)
    R, C = 37, 256
    data = rng.integers(-(2**31), 2**31 - 1, (R, C)).astype(np.int32)
    rows = rng.integers(0, R, M).astype(np.int32)
    if ids in ("first", "edges"):
        rows[0] = 0
    if ids in ("last", "edges"):
        rows[-1] = R - 1
    got = cs.row_gather(torch.from_numpy(data), torch.from_numpy(rows))
    assert got.shape == (M, C) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), data[rows])


@pytest.mark.parametrize("T", [0, 4])
def test_match_units_keys_through_row_order(T):
    """Key-emit mode for two queries, each reading its rows through its
    own order up to its own count: logical row i is bucket row
    rows[q, i], keyed with that row's corpus index (-1 on padding)."""
    rng = np.random.default_rng(90 + T)
    W, n, B = 64, 20, 768
    needles = np.stack([_needle(rng, n), _needle(rng, n)])
    halves = [_rows(rng, B // 2, W, nd) for nd in needles]
    cp = np.concatenate([h[0] for h in halves])
    nu = np.concatenate([h[1] for h in halves])
    idx = rng.permutation(B).astype(np.int32)
    idx[rng.random(B) < 0.05] = -1
    rows = np.stack([rng.permutation(B) for _ in range(2)]).astype(np.int32)
    counts = [B - 100, 300]
    scal = tk.pack_needle_scalars(torch.from_numpy(needles), 0)
    scal[:, 0] = torch.tensor(counts)
    got = tk.match_units(
        torch.from_numpy(cp), torch.from_numpy(nu), scal,
        torch.from_numpy(rows), torch.from_numpy(idx),
        n=n, max_typos=T, scoring=tk.DEFAULT_SCORING, idx_bits=10,
    ).numpy()
    for q in range(2):
        c = counts[q]
        sel = rows[q, :c]
        out8 = _reference_cols(cp[sel], nu[sel], needles[q], c, T=T,
                               no_pre=False, scoring=tk.DEFAULT_SCORING)
        want, _cnt = jbatch._keys_from_cols(
            jnp.asarray(out8[:, 0] > 0), jnp.asarray(out8[:, 1]),
            jnp.asarray(out8[:, 2] > 0), jnp.asarray(out8[:, 3]),
            jnp.asarray(out8[:, 4] > 0), jnp.asarray(idx[sel]), 10,
        )
        np.testing.assert_array_equal(got[q, :c], np.asarray(want))
        assert (got[q, c:] == tk.INT64_MAX).all()
        assert (got[q, :c] != tk.INT64_MAX).any()


def test_survivor_order_matches_reference_key():
    """Stage-1 survivors first, each part by (unit count, row): the
    reference's packed [reject | n_units | row] survivor sort."""
    rng = np.random.default_rng(4)
    B, W = 1000, 64
    s1 = rng.random((3, B)) < 0.3
    nu = rng.integers(0, W + 1, B).astype(np.int32)
    got = tbatch._survivor_order(torch.from_numpy(s1), torch.from_numpy(nu),
                                 W).numpy()
    bbits = (B - 1).bit_length()
    keyb = (nu.astype(np.int64) << bbits) | np.arange(B)
    key = np.where(s1, keyb, keyb | (1 << (bbits + W.bit_length())))
    np.testing.assert_array_equal(got, np.sort(key, axis=1) & ((1 << bbits)
                                                              - 1))


def _serve_both(port, ref, queries, k, route, *, full=False, **cfg):
    """Both packages' serving arrays for one shape-uniform batch: the
    count header and the first min(count, k) rows (all rows when
    ``full``); asserts the port's row-major flow."""
    before = dict(tbatch.ROW_MAJOR_ROUTES)
    pm = [tm.Matcher.from_query(q, Config(**cfg)) for q in queries]
    (got, _ready, members), = tm._dispatch_batch_groups(
        pm, port, Config(**cfg), k)
    jms = [jm.Matcher.from_query(q, JConfig(**cfg)) for q in queries]
    (want, jmembers), = jm._dispatch_batch_groups(jms, ref, JConfig(**cfg),
                                                  k)[0]
    assert members == jmembers
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for q in range(got.shape[0]):
        m = 1 + min(int(got[q, 0, 0]), got.shape[1] - 1)
        np.testing.assert_array_equal(got[q, :m], want[q, :m])
    if full:
        np.testing.assert_array_equal(got, want)
    taken = {r for r, c in tbatch.ROW_MAJOR_ROUTES.items() if c > before[r]}
    assert taken == {route}, taken
    return got


def _topk_both(port, ref, queries, k, **cfg):
    got = match_topk_batch(queries, port, Config(**cfg), k=k)
    want = jm.match_topk_batch(queries, ref, JConfig(**cfg), k=k)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    return got


# One 32,768-row w128 bucket whose survivor counts put the reference's
# capacity switch on each tier: caps are 2048 (1/16), 4096 (1/8) and 8192
# (1/4) rows; four letter families of 1500, 3000, 6000 and 9000 rows each
# carry their own 17-unit needle, the filler carries none of them.
TIER_FAMILIES = (("abcd", 1500, 16), ("efgh", 3000, 8), ("ijkl", 6000, 4),
                 ("mnop", 9000, 0))


def _tier_needle(letters):
    return (letters * 5)[:17]


@pytest.fixture(scope="module")
def tier_corpus():
    rng = np.random.default_rng(2024)
    filler = np.frombuffer(b"qrstuvwxyz0123456789QRSTUVWXYZ_-/", np.uint8)
    hay = []
    for letters, rows, _div in TIER_FAMILIES + (("", 12000, None),):
        needle = np.frombuffer(_tier_needle(letters).encode(), np.uint8)
        for _ in range(rows):
            length = int(rng.integers(100, 121))
            row = rng.choice(filler, length)
            if len(needle):
                pos = np.sort(rng.choice(length, len(needle), replace=False))
                row[pos] = needle
            hay.append(row.tobytes().decode())
    order = rng.permutation(len(hay))
    hay = [hay[i] for i in order]
    return hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)


@pytest.mark.parametrize("family", range(len(TIER_FAMILIES)))
def test_serving_capacity_tiers(tier_corpus, family):
    """Each family's needle drives the reference to its tier (1/16, 1/8,
    1/4, else the in-place flow); the port serves all of them through
    the survivor order."""
    hay, port, ref = tier_corpus
    letters, rows, div = TIER_FAMILIES[family]
    (b,) = ref.buckets
    B, W = b.cp.shape
    assert W == 128 and B == 32768
    caps = {d: jbatch._bucket_cap(B, W, d) for d in (16, 8, 4)}
    tier = next((d for d in (16, 8, 4) if rows <= caps[d]), 0)
    assert tier == div
    needle = _tier_needle(letters)
    nq = tm.Matcher.from_query(needle)._compiled[0].engine._host_needle()
    need, tot = needle_need_matrix(
        torch.from_numpy(np.concatenate(nq[:2])[None]))
    bits = port.buckets[0].device_presence_bits()
    assert int((presence_hits(bits, need) >= tot).sum()) == rows
    out = _serve_both(port, ref, [needle, needle.upper()], 40, "compacted",
                      full=div == 0)
    assert out[1, 0, 0] == 0  # smart case: the upper-case needle is exact
    assert out[0, 0, 0] == rows
    _topk_both(port, ref, [needle], 40)


@pytest.fixture(scope="module")
def partial():
    hay = datagen.partial_match_corpus(median_length=24, num_samples=4500,
                                       seed=7)
    hay += [h * 4 for h in datagen.partial_match_corpus(
        median_length=9, num_samples=1500, seed=8)]
    return hay, pack_corpus(hay, device="cpu"), j_pack(hay, unicode=False)


@pytest.mark.parametrize("queries,cfg", [
    (["deadbeef", "feedbead", "beadfeed"], {"max_typos": 4}),
    (["deadbeefdead", "beefdeadbeef"], {"max_typos": 8}),
])
def test_serving_stage1_batches(partial, queries, cfg):
    """Typo budgets of 4 and 8 over a corpus of two bucket widths (w32
    and w64, which the reference packs 4 and 2 rows to a vector): the
    compacted flow, and the decoded top-k against the reference's and
    its host oracle."""
    from frizbee_tpu.matcher import Matcher as JMatcher

    hay, port, ref = partial
    assert [b.width for b in port.buckets] == [32, 64]
    _serve_both(port, ref, queries, 50, "compacted", **cfg)
    got = _topk_both(port, ref, queries, 50, **cfg)
    for q, g in zip(queries, got):
        oracle = JMatcher.from_query(q, JConfig(**cfg), use_device=False
                                     ).match_arrays(ref)
        assert g[0] == len(oracle[0])
        for a, b in zip(g[1:], oracle):
            np.testing.assert_array_equal(a, b[:50])


@pytest.mark.parametrize("queries,cfg", [
    (["deadbeefdeadbeefab"], {"max_typos": None}),  # no prefilter
    (["dead", "beef"], {"max_typos": 8}),  # budget covers the needle
])
def test_serving_in_place_batches(partial, queries, cfg):
    """Without a stage-1 reject every row runs in bucket order, as in the
    reference's in-place flow: the arrays are equal element for
    element."""
    hay, port, ref = partial
    out = _serve_both(port, ref, queries, 60, "in_place", full=True, **cfg)
    assert (out[:, 0, 0] == len(hay)).all()


def test_serving_empty_batch(tier_corpus):
    """No query has a stage-1 survivor: the all-zero result."""
    _hay, port, ref = tier_corpus
    out = _serve_both(port, ref, ["~" * 17, "@" * 17], 40, "compacted",
                      full=True)
    assert not out.any()
