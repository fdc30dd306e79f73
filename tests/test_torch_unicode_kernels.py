"""The unicode (codepoint) branch of the port's three match kernels — the
plain versions, which the CUDA kernels are held against on the card —
against frizbee_tpu's Pallas kernels in interpret mode: the column-stream
fuzzy kernel (T=0, T=1, no prefilter; flags; key-emit; with and without
the ctx plane), the column-stream literal kernel in its four modes, and
the row-major kernel with the reference's narrow-bucket segment packing.

Rows and needles mix 1- to 4-byte code points (é, €, 𐍈, ل, Л, 가, 😀),
case pairs and delimiters, made with numpy from a seed and handed to both
packages. Every comparison has zero tolerance: the five result columns,
and in key-emit mode the int64 key against the reference's
(hi << 32) | lo halves."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frizbee_tpu.ops import colstream as jcs
from frizbee_tpu.ops import kernels as jk
from frizbee_tpu_torch.config import Config, Matching, UnicodeMatching
from frizbee_tpu_torch.corpus import pack_corpus
from frizbee_tpu_torch.engine import make_engine
from frizbee_tpu_torch.ops import colstream as tcs
from frizbee_tpu_torch.ops import kernels as tk

SC = tk.DEFAULT_SCORING
NEEDLES = ["é", "€𐍈", "لi", "Линукс", "가나다"]
NOISE = list("abcXYZ/ _-éÉ€𐍈لЛл가다😀")
MODES = ["exact", "prefix", "suffix", "substring"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _needle(s, matching=Matching.FUZZY):
    """(orig then flip codepoints, needle bytes) as the serving path
    packs a unicode needle."""
    eng = make_engine(s, Config(unicode=UnicodeMatching.ALWAYS,
                                matching=matching))
    o, f, _sc = eng._host_needle()
    return np.concatenate([o, f]), len(eng.needle_bytes)


def _rows(rng, count, width, needles):
    """Strings of 0..width code points of mixed byte lengths, about a third
    carrying one needle's units in order (a unit dropped now and then),
    some the needle alone or in a case flip."""
    out = []
    for i in range(count):
        n = int(rng.integers(0, width + 1)) if rng.random() < 0.6 \
            else int(rng.integers(0, 8))
        row = list(rng.choice(NOISE, n))
        nd = needles[i % len(needles)]
        if rng.random() < 0.35 and n >= len(nd):
            units = list(nd)
            if len(units) > 1 and rng.random() < 0.3:
                del units[int(rng.integers(0, len(units)))]
            pos = np.sort(rng.choice(n, len(units), replace=False))
            for p, u in zip(pos, units):
                row[p] = u
        out.append("".join(row))
    out += [nd for nd in needles] + [nd.upper() for nd in needles]
    return out


def _blocks(rows, width):
    """The port's colstream blocks of a one-bucket unicode corpus:
    (cpT, nuT, idxT, blk_bits, ctxT) as numpy."""
    c = pack_corpus(rows, unicode=True, bucket_widths=(width,), device="cpu")
    (b,) = c.buckets
    return tuple(t.numpy() for t in b.device_arrays_colstream())


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(31)
    return _blocks(_rows(rng, 1150, 64, NEEDLES), 64)


def _scal(needles, count):
    return tk.pack_needle_scalars(torch.from_numpy(np.stack(needles)), count)


def _ref(blocks_np, needle, count, flags=None, keys=False, ctx=True, **kw):
    cpT, nuT, idxT, _blk, ctxT = blocks_np
    return jcs.match_units_colstream(
        jnp.asarray(cpT), jnp.asarray(nuT),
        jk.pack_needle_scalars(jnp.asarray(needle), count),
        None if flags is None else jnp.asarray(flags),
        jnp.asarray(idxT.reshape(-1, 128)) if keys else None,
        jnp.asarray(ctxT) if ctx else None,
        unicode=True, interpret=True, scoring=SC, **kw,
    )


def _port(blocks_np, needles, count, flags=None, keys=False, ctx=True,
          **kw):
    cpT, nuT, idxT, _blk, ctxT = blocks_np
    return tcs.match_units_colstream(
        torch.from_numpy(cpT), torch.from_numpy(nuT), _scal(needles, count),
        None if flags is None else torch.from_numpy(flags),
        torch.from_numpy(idxT) if keys else None,
        torch.from_numpy(ctxT) if ctx else None, scoring=SC, **kw,
    )


def _assert_cols(got, want, q=0):
    for i in range(5):
        np.testing.assert_array_equal(got[i][q].numpy(), np.asarray(want[i]),
                                      err_msg=f"col{i}")


def _assert_keys(got, want, q):
    hi, lo, m = (np.asarray(x) for x in want)
    k = (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got[q].numpy(), k)
    np.testing.assert_array_equal((got[q].numpy() != tk.INT64_MAX)
                                  .astype(np.int32), m)


@pytest.mark.parametrize("T", [0, 1, None])
@pytest.mark.parametrize("needle", NEEDLES)
def test_fuzzy_columns(blocks, needle, T):
    """Five-column mode over two groups with the ctx plane, against the
    reference; the port's derived-context path (no plane) gives the same
    columns."""
    nd, _nbl = _needle(needle)
    n = len(nd) // 2
    count = blocks[1].size
    kw = dict(W=64, n=n, max_typos=0 if T is None else T,
              no_prefilter=T is None)
    got = _port(blocks, [nd], count, **kw)
    _assert_cols(got, _ref(blocks, nd, count, **kw))
    derived = _port(blocks, [nd], count, ctx=False, **kw)
    for a, b in zip(got, derived):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


def test_fuzzy_keys_flags_and_derived_context(blocks):
    """Key-emit mode for two queries with alive and dead groups and a
    live count inside the last group, against the reference with and
    without the ctx plane."""
    needles = [_needle("لi")[0], _needle("€𐍈")[0]]
    flags = np.array([[1, 0], [1, 1]], np.int32)
    count = 1024 + 300
    for ctx in (True, False):
        got = _port(blocks, needles, count, flags, keys=True, ctx=ctx,
                    W=64, n=2, idx_bits=11)
        for q in range(2):
            _assert_keys(got, _ref(blocks, needles[q], count, flags[q],
                                   keys=True, ctx=ctx, W=64, n=2,
                                   idx_bits=11), q)
    assert (got[0, 1024:].numpy() == tk.INT64_MAX).all()  # dead group
    assert (got[1].numpy() != tk.INT64_MAX).any()


@pytest.mark.parametrize("mode", MODES)
def test_literal_modes(blocks, mode):
    """Each literal mode for two-codepoint needles of 3, 4 and 6 bytes
    (end_col and the exact flag count bytes), five-column and key-emit."""
    count = blocks[1].size
    matched = 0
    for s in ("لi", "€𐍈", "가나"):
        nd, nbl = _needle(s, Matching.EXACT)
        kw = dict(W=64, n=2, mode=mode, needle_byte_len=nbl)
        got = _port(blocks, [nd], count, **kw)
        _assert_cols(got, _ref(blocks, nd, count, **kw))
        assert not got[4].any()
        matched += int(got[0].sum())
    assert matched > 0
    keys = _port(blocks, [nd], count, keys=True, idx_bits=11, **kw)
    _assert_keys(keys, _ref(blocks, nd, count, keys=True, idx_bits=11, **kw),
                 0)


def _ref_rowmajor(cp, nu, needle, count, T, no_pre):
    """The reference's match_units as its serving path runs it on a
    unicode bucket: narrow buckets packed 128 // W rows per vector (zero
    rows pad the count to whole vectors)."""
    rows, W = cp.shape
    pad = (-rows) % max(1, 128 // W)
    cp = np.pad(cp, ((0, pad), (0, 0)))
    nu = np.pad(nu, (0, pad))
    cp_k, nu_k, seg, g = jk.pack_rows_for_kernel(jnp.asarray(cp),
                                                 jnp.asarray(nu[:, None]))
    cnt = -(-count // g) if g > 1 else count
    out = jk.match_units(
        cp_k, nu_k, jk.pack_needle_scalars(jnp.asarray(needle), cnt),
        max_typos=T, scoring=SC, unicode=True, no_prefilter=no_pre,
        interpret=True, seg=seg,
    )
    return np.asarray(out).reshape(-1, 8)[:rows]


@pytest.mark.parametrize("W,needle,T", [
    (32, "لinux€𐍈é", 4),
    (64, "Линукс가나다linux€𐍈éلiab", 0),
])
def test_rowmajor(W, needle, T):
    """The row-major kernel at (n=8, T=4) on a w32 bucket and at (n=20,
    T=0) on a w64 one, both of which the reference packs several rows to
    a vector; columns mode for the live rows, and key-emit through a
    row order."""
    rng = np.random.default_rng(W + T)
    rows = _rows(rng, 600, W, [needle, needle[1:], needle[::-1]])
    c = pack_corpus(rows, unicode=True, bucket_widths=(W,), device="cpu")
    (b,) = c.buckets
    cp, nu, idx = (t.numpy() for t in b.device_arrays_units())
    nd, _nbl = _needle(needle)
    n = len(nd) // 2
    count = b.size - 37
    got = tk.match_units(
        torch.from_numpy(cp), torch.from_numpy(nu), _scal([nd], count),
        n=n, max_typos=T, scoring=SC,
    )[0].numpy()
    want = _ref_rowmajor(cp, nu, nd, count, T, False)
    np.testing.assert_array_equal(got[:count], want[:count])
    assert not got[count:].any() and got[:count, 0].any()
    order = rng.permutation(b.size).astype(np.int32)
    keys = tk.match_units(
        torch.from_numpy(cp), torch.from_numpy(nu), _scal([nd], count),
        torch.from_numpy(order[None]), torch.from_numpy(idx),
        n=n, max_typos=T, scoring=SC, idx_bits=11,
    )[0].numpy()
    sel = order[:count]
    want_k = tk.pack_keys(
        *(torch.from_numpy(np.array(want_c)) for want_c in
          _ref_rowmajor(cp[sel], nu[sel], nd, count, T, False).T[:5]),
        torch.from_numpy(idx[sel]), 11,
    ).numpy()
    np.testing.assert_array_equal(keys[:count], want_k)
    assert (keys[count:] == tk.INT64_MAX).all()


# windows whose start-1 trim lands one byte before a multi-byte unit, and
# rows whose trimmed window spans more than 1024 bytes (greedy)
STRADDLE_ROWS = [
    "€" * 120 + "linux" + "€" * 80,
    "a" * 199 + "لlinux",
    ("li" + "𐍈" * 50) * 2 + "nux",
    "l" + "€" * 400 + "inux",
    "L" + "😀" * 300 + "inux" + "€" * 30,
    "x" + "가" * 200 + "linux",
]


@pytest.mark.parametrize("W", [256, 512])
def test_trim_straddle_and_greedy(W):
    """256- and 512-wide buckets: byte windows that straddle multi-byte
    context, and on w512 windows over 1024 bytes that set the greedy
    bit; the colstream fuzzy kernel at T=0 and T=1 and the row-major
    kernel at T=4."""
    rows = [r for r in STRADDLE_ROWS if len(r) <= W]
    bl = _blocks(rows, W)
    nd, _nbl = _needle("linux")
    for T in (0, 1):
        kw = dict(W=W, n=5, max_typos=T)
        got = _port(bl, [nd], bl[1].size, **kw)
        _assert_cols(got, _ref(bl, nd, bl[1].size, **kw))
        assert int(got[4].sum()) == (2 if W == 512 else 0)
    c = pack_corpus(rows, unicode=True, bucket_widths=(W,), device="cpu")
    cp, nu, _idx = (t.numpy() for t in c.buckets[0].device_arrays_units())
    got = tk.match_units(torch.from_numpy(cp), torch.from_numpy(nu),
                         _scal([nd], len(rows)), n=5, max_typos=4,
                         scoring=SC)[0].numpy()
    np.testing.assert_array_equal(
        got[:len(rows)], _ref_rowmajor(cp, nu, nd, len(rows), 4,
                                       False)[:len(rows)])
