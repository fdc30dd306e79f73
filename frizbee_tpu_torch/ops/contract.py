"""The lane contract: every per-thread device helper of the match kernels
(``csrc/kernel_common.cuh``), every s16x2 operation of the int16-lane
kernels (``csrc/lanes16.cuh``) and the row walks that stand in for the
reference's lane primitives, evaluated by one CUDA kernel
(``csrc/lane_contract.cu``) beside its plain PyTorch model.

Counterpart of two TPU kernels of the reference: the lane-helper harness
of ``tests/test_kernel_contract.py`` (``run_in_kernel``: frizbee_tpu's lane
primitives inside a ``pallas_call`` against NumPy models, int32 and int16
lanes) and the op-lowering half of ``benchmarks/probe_colstream_int16.py``
(which 16-bit vector operations a target lowers). The reference's
cross-lane primitives (``_shift_right``, ``_cumsum_lanes``,
``_cummax_lanes``, ``_gather_lane``, ``_rmin``/``_rmax`` and
``_unit_context``'s byte offsets) become the serial walk a thread makes
along its row: the kernel walks rows of 128 lanes in int32 and int16
arithmetic, and the model computes the same quantities with the port's
row helpers (``ops/kernels.py``), which tests/test_torch_lane_contract.py
holds against the reference's primitives on the CPU.

:func:`contract_inputs` makes the inputs from a seed: every byte and a
boundary set of codepoints, every (first, last) byte pair, serving keys
at their field edges, packed int16 words at the values the DP reaches
and at sums that cross +-32767, and rows of values, summands and units
with a shift distance, fill, gather lane, unit count and codepoint flag
each. :func:`lane_contract` runs the kernel on a CUDA tensor (its plain
version on a CPU tensor); :func:`contract_plain` is the model it is held
to, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .colstream import _bonus_bits
from .kernels import (
    _lane_gather,
    _lane_max,
    _lane_min,
    _unit_context,
    is_delim,
    is_lower,
    is_upper,
    pack_keys,
    utf8_context,
)
from ..corpus import CTX_BLEN_SHIFT, CTX_DELIM_FIRST, CTX_DELIM_LAST
from ..corpus import CTX_LOWER_LAST, CTX_UPPER_FIRST

UNIT_OUT = 6   # is_upper, is_lower, is_delim, byte_ctx, codepoint_ctx, blen
PAIR_OUT = 2   # bonus_bits(x, y), context_bonus(x, y)
KEY_IN = 7     # matched, score, exact, end_col, greedy, idx, idx_bits
WORD_IN = 7    # packed words a..f, unit index k
WORD_OUT = 17  # see csrc/lane_contract.cu
ROW_LANES = 128
ROW_IN = 3     # x (values), p (summands), u (units)
ROW_ARGS = 5   # shift distance, fill, gather lane, unit count, codepoint
# shift, prefix sum, running max, first, prev, offset, length (ROW_LANES
# each), then gather, min, max, byte count
ROW_OUT = 7 * ROW_LANES + 4
ROW_TYPES = (torch.int32, torch.int16)  # the two halves of rows_out
# the shift distances the rows take, each with its fill
SHIFTS = ((1, -5), (2, 0), (7, -1), (64, -20000), (127, -30000))

# int16 values of the DP's reach and its edges (the reference's int16
# NEG is -20000; cells stay below 30000)
INT16_EDGES = (-32768, -32767, -30000, -20001, -20000, -12, -1, 0, 1, 2, 12,
               1292, 20000, 29999, 30000, 32766, 32767)
CODEPOINT_EDGES = (0x7F, 0x80, 0x7FF, 0x800, 0xD7FF, 0xE000, 0xFFFF, 0x10000,
                   0x10FFFF, 0x0627, 0x0644, 0xAC00, 0x1F600, 0x10348)


def contract_inputs(seed: int = 0, device="cpu", n_random: int = 4096,
                    n_rows: int = 40):
    """(units, pairs, keys, words, rows, row_args) int32 tensors on
    ``device``: bytes 0-255, CODEPOINT_EDGES and random codepoints; every
    (x, y) byte pair; random keys with end columns past the 14-bit field,
    scores at 0 and 0xFFFF, index widths 1-31 and padding indices; words
    whose low halves run over every pair of INT16_EDGES and random words,
    with unit indices 0-63; rows of values in [-100, 30000) and at the
    int16 edges, summands 0-4 and units (ASCII and multi-byte codepoints),
    each with a (distance, fill) of SHIFTS, a gather lane, a unit count
    in 0..128 (0 and 128 among them) and a codepoint flag."""
    rng = np.random.default_rng(seed)
    units = np.concatenate([
        np.arange(256), np.array(CODEPOINT_EDGES),
        rng.integers(0, 0x110000, n_random)])
    xy = np.arange(256)
    pairs = np.stack(np.meshgrid(xy, xy, indexing="ij"), -1).reshape(-1, 2)
    nk = n_random
    idx_bits = rng.integers(1, 32, nk)
    idx = rng.integers(0, 1 << 31, nk) % (1 << idx_bits)
    idx = np.where(rng.random(nk) < 0.1, -1, idx)
    score = rng.integers(0, 0x10000, nk)
    score[:4] = (0, 0xFFFF, 0, 0xFFFF)
    keys = np.stack([
        rng.integers(0, 2, nk), score, rng.integers(0, 2, nk),
        rng.integers(0, 0x5000, nk), rng.integers(0, 2, nk), idx, idx_bits,
    ], 1)
    edges = np.array(INT16_EDGES)
    ea, eb = np.meshgrid(edges, edges, indexing="ij")
    ne = ea.size

    def halves(n, lo=None):
        pick = np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                        rng.integers(-20000, 30000, n))
        lo = pick if lo is None else lo
        hi = np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                      rng.integers(-20000, 30000, n))
        return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)

    nw = ne + n_random
    cols = [halves(nw, np.concatenate([ea.ravel(),
                                       rng.integers(-20000, 30000, n_random)])),
            halves(nw, np.concatenate([eb.ravel(),
                                       rng.integers(-20000, 30000, n_random)]))]
    cols += [halves(nw) for _ in range(4)]
    # a third of the c words are half masks, as sel2 and hit2 take them
    masks = rng.choice(np.array([0, 0xFFFF, 0xFFFF0000, 0xFFFFFFFF]), nw)
    cols[2] = np.where(rng.random(nw) < 0.33, masks, cols[2])
    words = np.stack(cols + [rng.integers(0, 64, nw)], 1)

    R, L = n_rows, ROW_LANES
    x = rng.integers(-100, 30000, (R, L))
    x = np.where(rng.random((R, L)) < 0.1, rng.choice(edges, (R, L)), x)
    pool = np.concatenate([np.arange(0x20, 0x7F), np.array(CODEPOINT_EDGES)])
    rows = np.stack([x, rng.integers(0, 5, (R, L)),
                     rng.choice(pool, (R, L))], 1)
    shift = np.array(SHIFTS)[np.arange(R) % len(SHIFTS)]
    nu = rng.integers(0, L + 1, R)
    nu[:2] = (0, L)
    row_args = np.stack([shift[:, 0], shift[:, 1], rng.integers(0, L, R), nu,
                         np.arange(R) // 2 % 2], 1)

    def i32(a):
        return torch.from_numpy(
            (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32)
            .view(np.int32)).to(device)

    return (i32(units), i32(pairs), i32(keys), i32(words), i32(rows),
            i32(row_args))


def _u32(t):
    """int32 bit patterns -> their uint32 values in int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _s16(w, shift):
    return (((w >> shift) & 0xFFFF) ^ 0x8000) - 0x8000


def _pack(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _wrap16(x):
    """A 16-bit lane's sum: two's complement, the carry out dropped."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _per_half(fn, *words):
    return _pack(fn(*(_s16(w, 0) for w in words)),
                 fn(*(_s16(w, 16) for w in words)))


def _bit(w, k):
    return (w >> k) & 1


def _half_masks(lo, hi, k):
    return _pack(-_bit(lo, k), -_bit(hi, k))


def _sel2(m, a, b):
    return (a & m) | (b & ~m & 0xFFFFFFFF)


def _addmax(a, b, c):
    return _per_half(lambda x, y, z: torch.maximum(_wrap16(x + y), z), a, b, c)


def _addmax_relu(a, b, c):
    return _per_half(lambda x, y, z: torch.clamp(
        torch.maximum(_wrap16(x + y), z), min=0), a, b, c)


def _row_lanes(rows, row_args, dtype):
    """The rows half of the model in lane type ``dtype``: (R, ROW_OUT)
    int32, from the port's row helpers."""
    R, L = rows.shape[0], ROW_LANES
    x, p, u = rows[:, 0].to(dtype), rows[:, 1].to(dtype), rows[:, 2]
    d, fill, at, nu, cp = (row_args[:, i] for i in range(ROW_ARGS))
    col = torch.arange(L, dtype=torch.int32, device=rows.device)[None, :]
    src = col - d[:, None]
    shift = torch.where(src >= 0, x.gather(1, src.clamp(min=0).long()),
                        fill[:, None].to(dtype))
    valid = col < nu[:, None]
    on_cp = cp[:, None] != 0
    ctx = [torch.where(on_cp if a.dim() == 2 else on_cp[:, 0], a, b)
           for a, b in zip(_unit_context(u, valid, col),
                           _unit_context((u & 0xFF).to(torch.int8), valid,
                                         col))]
    first, prev, boff, blen, n_bytes = (c.to(dtype) for c in ctx)
    first = torch.where(valid, first, 0)
    out = [shift, torch.cumsum(p, dim=1, dtype=dtype),
           torch.cummax(x, dim=1).values, first, prev, boff, blen,
           _lane_gather(x, at)[:, None], _lane_min(x)[:, None],
           _lane_max(x)[:, None], n_bytes[:, None]]
    return torch.cat([o.to(torch.int32) for o in out], 1).reshape(R, ROW_OUT)


def contract_plain(units, pairs, keys, words, rows, row_args, scoring):
    """The plain model of :func:`lane_contract`: the same five outputs
    from the same inputs, computed with torch integer ops."""
    (_m, _mm, _go, _ge, _pre, cap_b, _case, _ex, delim_b) = (
        int(s) for s in scoring)
    c = units.to(torch.int64)
    first, last, blen = utf8_context(c, torch.ones_like(c, dtype=torch.bool))
    cp_ctx = _bonus_bits(first, last) | (blen << CTX_BLEN_SHIFT)
    units_out = torch.stack([
        is_upper(c).to(torch.int64), is_lower(c).to(torch.int64),
        is_delim(c).to(torch.int64),
        _bonus_bits(c, c) | (1 << CTX_BLEN_SHIFT), cp_ctx,
        (cp_ctx >> CTX_BLEN_SHIFT) & 7,
    ], 1).to(torch.int32)

    x, y = pairs[:, 0].to(torch.int64), pairs[:, 1].to(torch.int64)
    bonus = (torch.where(((x & CTX_UPPER_FIRST) > 0)
                         & ((y & CTX_LOWER_LAST) > 0), cap_b, 0)
             + torch.where(((y & CTX_DELIM_LAST) > 0)
                           & ((x & CTX_DELIM_FIRST) == 0), delim_b, 0))
    pairs_out = torch.stack([_bonus_bits(x, y), bonus], 1).to(torch.int32)

    k = keys.to(torch.int64)
    keys_out = pack_keys(k[:, 0], k[:, 1], k[:, 2], k[:, 3], k[:, 4], k[:, 5],
                         k[:, 6])

    w = _u32(words)
    a, b, cw, d, e, f = (w[:, i] for i in range(6))
    kk = w[:, 6]
    vib = _per_half(torch.maximum, a, b)
    preds = ((_s16(a, 0) >= _s16(b, 0)).to(torch.int64)
             | ((_s16(a, 16) >= _s16(b, 16)).to(torch.int64) << 1))
    p16 = (a & 0xFFFF) | ((b & 0xFFFF) << 16)
    k15 = kk & 15
    t = _addmax_relu(e, f, torch.zeros_like(e))
    cell = _addmax(a, b, _addmax(cw, d, t))
    lo64, hi64 = a | (b << 32), cw | (d << 32)
    words_out = torch.stack([
        _addmax(a, b, cw),
        _addmax_relu(a, b, cw),
        _per_half(lambda p, q, r: torch.maximum(torch.maximum(p, q), r),
                  a, b, cw),
        _per_half(lambda p, q, r: torch.clamp(
            torch.maximum(torch.maximum(p, q), r), min=0), a, b, cw),
        vib,
        preds,
        _half_masks(a, b, kk & 31),
        _half_masks(a, a >> 16, k15),
        p16,
        (a >> 16) | ((b >> 16) << 16),
        _sel2(cw, a, b),
        _sel2(a, _sel2(b, cw, d), e),
        cell,
        _half_masks(lo64, hi64, kk & 63),
        _half_masks(p16, p16 >> 16, k15),
        vib,
        (_s16(b, 0) > _s16(a, 0)).to(torch.int64)
        | ((_s16(b, 16) > _s16(a, 16)).to(torch.int64) << 1),
    ], 1)
    words_out = torch.where(words_out >= (1 << 31), words_out - (1 << 32),
                            words_out).to(torch.int32)
    rows_out = torch.stack([_row_lanes(rows, row_args, t)
                            for t in ROW_TYPES])
    return units_out, pairs_out, keys_out, words_out, rows_out


def lane_contract(units, pairs, keys, words, rows, row_args, scoring):
    """Run the contract kernel on the inputs' CUDA device (the plain model
    for CPU tensors): (units_out (N, 6) int32, pairs_out (P, 2) int32,
    keys_out (K,) int64, words_out (M, 17) int32 bit patterns, rows_out
    (2, R, ROW_OUT) int32, int32 lanes then int16 lanes). Inputs as
    :func:`contract_inputs` makes them."""
    if units.device.type == "cpu":
        return contract_plain(units, pairs, keys, words, rows, row_args,
                              scoring)
    if units.device.type != "cuda":
        raise ValueError(f"unsupported device {units.device}")
    dev = units.device
    N, P, K, M = units.shape[0], pairs.shape[0], keys.shape[0], words.shape[0]
    R = rows.shape[0]
    _build.check_operands(dev, (
        ("units", units, torch.int32, (N,)),
        ("pairs", pairs, torch.int32, (P, 2)),
        ("keys", keys, torch.int32, (K, KEY_IN)),
        ("words", words, torch.int32, (M, WORD_IN)),
        ("rows", rows, torch.int32, (R, ROW_IN, ROW_LANES)),
        ("row_args", row_args, torch.int32, (R, ROW_ARGS)),
    ))
    units_out = torch.empty((N, UNIT_OUT), dtype=torch.int32, device=dev)
    pairs_out = torch.empty((P, PAIR_OUT), dtype=torch.int32, device=dev)
    keys_out = torch.empty((K,), dtype=torch.int64, device=dev)
    words_out = torch.empty((M, WORD_OUT), dtype=torch.int32, device=dev)
    rows_out = torch.empty((len(ROW_TYPES), R, ROW_OUT), dtype=torch.int32,
                           device=dev)
    _sc, sc_ptr = _build.scoring_arg(scoring)
    ptr = _build.ptr
    _build.launch(
        "lane_contract", dev, ptr(units), N, ptr(pairs), P, ptr(keys), K,
        ptr(words), M, ptr(rows), ptr(row_args), R, sc_ptr, ptr(units_out),
        ptr(pairs_out), ptr(keys_out), ptr(words_out), ptr(rows_out),
        _build.stream(units),
        call=((units, pairs, keys, words, rows, row_args),
              dict(scoring=scoring)),
    )
    return units_out, pairs_out, keys_out, words_out, rows_out
