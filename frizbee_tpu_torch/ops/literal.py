"""Literal matching modes, and the generic (B, W) literal pipelines:
exact / prefix / suffix / substring as plain PyTorch ops over a bucket.

Counterpart of ``frizbee_tpu/ops/literal.py`` (plain XLA there too). The
column-stream literal kernel (``ops/colstream.py``,
``csrc/colstream_literal.cu``) serves needles of up to 16 units; these
pipelines serve the rest and the engines' per-pattern ``match_corpus``.
Per needle unit k, a match mask shifted left by k is ANDed into the
occurrence mask — n passes over the bucket. Scoring is the SW per-char
schedule (match + case + prefix/capitalization/delimiter bonuses, exact
bonus for whole-haystack runs; reference: src/literal/algo.rs:183-227)
through an exclusive prefix sum of the needle-independent per-unit
bonus. Substring keeps the highest-scoring occurrence, the earliest on
ties. ``max_typos`` is ignored (reference: src/literal/mod.rs:1-8).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fuzzy import _units
from .kernels import utf8_context

# mode statics
EXACT, PREFIX, SUFFIX, SUBSTRING = "exact", "prefix", "suffix", "substring"

LITERAL_MODES = (EXACT, PREFIX, SUFFIX, SUBSTRING)


def _shift_left(x, k, fill):
    if k == 0:
        return x
    pad = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, k:], pad], dim=1)


def _prefix_sum(x):
    """Inclusive int32 prefix sum along axis 1."""
    return torch.cumsum(x, dim=1, dtype=torch.int32)


def literal_context(first_byte, prev_last_byte, byte_off, n_units, *, n, W,
                    scoring):
    """Needle-value-independent context of one bucket: (valid, win_bonus,
    last_start, cols). It depends only on the corpus and the needle
    length ``n``, so the batched paths compute it once per (bucket,
    group) and share it across the queries."""
    (_ms, _mm, _gop, _gex, prefix_b, cap_b, _case_b, _exact_b,
     delim_b) = (int(s) for s in scoring)
    B = n_units.shape[0]
    cols = torch.arange(W, dtype=torch.int32,
                        device=n_units.device).expand(B, W)
    valid = cols < n_units[:, None]
    fb, pb = first_byte, prev_last_byte
    is_upper = (fb >= 0x41) & (fb <= 0x5A)
    prev_lower = (pb >= 0x61) & (pb <= 0x7A)

    def delim(b):
        letter = ((b >= 0x41) & (b <= 0x5A)) | ((b >= 0x61) & (b <= 0x7A))
        digit = (b >= 0x30) & (b <= 0x39)
        return (b >= 0) & (b <= 127) & ~letter & ~digit

    i32 = torch.int32
    bonus = torch.where(
        byte_off == 0,
        prefix_b,
        (is_upper & prev_lower).to(i32) * cap_b
        + (delim(pb) & ~delim(fb)).to(i32) * delim_b,
    ).to(i32)
    # windowed sum of the bonus over [p, p+n): exclusive prefix-sum
    # difference
    cumb = _prefix_sum(torch.where(valid, bonus, 0))
    cumb_excl = torch.cat(
        [torch.zeros((B, 1), dtype=i32, device=cumb.device), cumb[:, :-1]],
        dim=1)
    if n > 1:
        end_sum = torch.cat(
            [cumb[:, n - 1:], cumb[:, -1:].expand(B, n - 1)], dim=1)
    else:
        end_sum = cumb
    win_bonus = end_sum - cumb_excl
    last_start = n_units[:, None] - n
    return valid, win_bonus, last_start, cols


def literal_match_ctx(ctx, cp, n_units, n_bytes, byte_off, needle_orig,
                      needle_flip, *, mode, needle_byte_len, scoring):
    """Per-query half of the literal match over one bucket, given the
    hoisted :func:`literal_context`. Returns (matched, score, exact,
    end_col)."""
    (match_score, _mm, _gop, _gex, _pfx, _cap, case_b, exact_b,
     _dlm) = (int(s) for s in scoring)
    valid, win_bonus, last_start, cols = ctx
    B, W = cp.shape
    orig, flip = _units(needle_orig), _units(needle_flip)
    n = len(orig)
    i32 = torch.int32

    # occurrence mask: occ[:, p] == the needle matches units p..p+n-1;
    # match and exact-case bits share one int8 per (unit, k)
    occ = torch.ones((B, W), dtype=torch.bool, device=cp.device)
    case_cnt = torch.zeros((B, W), dtype=torch.int8, device=cp.device)
    for k in range(n):
        mk = ((valid & (cp == orig[k])).to(torch.int8)
              | ((valid & (cp == flip[k])).to(torch.int8) << 1))
        sh = _shift_left(mk, k, 0)
        occ = occ & (sh > 0)
        case_cnt = case_cnt + (sh & 1)
    occ = occ & (cols <= last_start)

    score_at = n * match_score + win_bonus + case_b * case_cnt.to(i32)
    # whole-haystack exact run bonus (only at p == 0 with the needle
    # covering every unit)
    covers = (n_units == n)[:, None] & (cols == 0)
    score_at = score_at + covers.to(i32) * exact_b
    score_at = torch.clamp(score_at, max=0xFFFF)

    if mode == EXACT:
        sel = occ & (cols == 0) & (n_units == n)[:, None]
    elif mode == PREFIX:
        sel = occ & (cols == 0)
    elif mode == SUFFIX:
        sel = occ & (cols == last_start)
    elif mode == SUBSTRING:
        sel = occ
    else:  # pragma: no cover
        raise ValueError(mode)

    masked = torch.where(sel, score_at, -1)
    best = masked.amax(dim=1)
    matched = best >= 0
    # earliest position achieving the best score (reference tie-break)
    pos = torch.where(masked == best[:, None], cols, W + 1).amin(dim=1)
    pos = torch.clamp(pos, 0, W - 1)
    pos_byte = torch.where(cols == pos[:, None], byte_off, 0).amax(dim=1)
    end_col = torch.where(
        matched, torch.clamp(pos_byte + needle_byte_len - 1, max=0xFFFF), 0)
    exact = matched & (pos == 0) & (n_bytes == needle_byte_len)
    score = torch.where(matched, best, 0)
    return matched, score.to(i32), exact, end_col.to(i32)


def literal_pipeline(cp, first_byte, prev_last_byte, byte_off, byte_len,
                     n_units, n_bytes, needle_orig, needle_flip, sc, *,
                     mode: str, needle_byte_len: int,
                     scoring: Tuple[int, ...]):
    """Batched literal match over one bucket (the (B, W) int32 planes of
    ``PackedBucket.device_arrays``). Returns (matched, score, exact,
    end_col, needs_greedy=False, wstart=0, wend=n_bytes), the fuzzy
    pipeline's output contract, so the generic body mixes pattern
    modes. ``sc`` is unused: the ``scoring`` static rules."""
    B, W = cp.shape
    n = len(_units(needle_orig))
    dev = cp.device
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    if n == 0 or n > W:
        return false, zeros, false, zeros, false, zeros, n_bytes.to(
            torch.int32)
    ctx = literal_context(first_byte, prev_last_byte, byte_off, n_units,
                          n=n, W=W, scoring=scoring)
    matched, score, exact, end_col = literal_match_ctx(
        ctx, cp, n_units, n_bytes, byte_off, needle_orig, needle_flip,
        mode=mode, needle_byte_len=needle_byte_len, scoring=scoring)
    return (matched, score, exact, end_col, false, zeros,
            n_bytes.to(torch.int32))


# The engines' entry point; JAX jits it, torch runs it eagerly
literal_match_bucket = literal_pipeline


def ascii_planes(cp8, n_units):
    """(cp, first, prev, byte_off, n_bytes) of int8 byte rows: the
    context planes :func:`literal_pipeline` reads, derived in place of
    the stored ones (a byte is its own first and last byte)."""
    B, W = cp8.shape
    cp = cp8.to(torch.int32) & 0xFF
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=cp.device), cp[:, :-1]], dim=1)
    cols = torch.arange(W, dtype=torch.int32, device=cp.device).expand(B, W)
    return cp, cp, prev, cols, n_units


def units_planes(cp32, n_units):
    """(cp, first, prev, byte_off, byte_len, n_bytes) of int32 codepoint
    rows: the UTF-8 context (same formulas as the kernels'
    ``utf8_context``) derived from the codepoints."""
    B, W = cp32.shape
    cols = torch.arange(W, dtype=torch.int32, device=cp32.device)[None, :]
    vmask = cols < n_units[:, None]
    cp = torch.where(vmask, cp32, 0)
    first, last, blen = utf8_context(cp, vmask)
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=cp.device), last[:, :-1]], dim=1)
    prev = torch.where(vmask, prev, -1)
    csum = _prefix_sum(blen)
    boff = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                  device=cp.device), csum[:, :-1]], dim=1)
    boff = torch.where(vmask, boff, 0)
    return cp, first, prev, boff, blen, csum[:, -1]


def literal_pipeline_ascii(cp8, n_units2, needle_orig, needle_flip, sc, *,
                           mode: str, needle_byte_len: int,
                           scoring: Tuple[int, ...]):
    """Byte-row adapter: the context derives from the int8 rows, so the
    kernels' corpus representation feeds the literal pipeline too."""
    nu = n_units2.reshape(-1)
    cp, first, prev, cols, nb = ascii_planes(cp8, nu)
    return literal_pipeline(cp, first, prev, cols, torch.ones_like(cp), nu,
                            nb, needle_orig, needle_flip, sc, mode=mode,
                            needle_byte_len=needle_byte_len, scoring=scoring)


def literal_pipeline_units(cp32, n_units2, needle_orig, needle_flip, sc, *,
                           mode: str, needle_byte_len: int,
                           scoring: Tuple[int, ...]):
    """Codepoint-row adapter: the UTF-8 byte context derives from the
    codepoints (:func:`units_planes`)."""
    nu = n_units2.reshape(-1)
    cp, first, prev, boff, blen, n_bytes = units_planes(cp32, nu)
    return literal_pipeline(cp, first, prev, boff, blen, nu, n_bytes,
                            needle_orig, needle_flip, sc, mode=mode,
                            needle_byte_len=needle_byte_len, scoring=scoring)
