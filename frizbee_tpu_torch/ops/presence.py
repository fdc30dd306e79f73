"""Stage-1 presence prefilter: the needle side of the batched matmul.

Each corpus row (and each 1024-row colstream group) carries capped
fold-bit occurrence planes (``corpus.PackedBucket``): plane k holds
"fold-bit c occurs more than k times". A query's need matrix counts its
own fold-bits the same way, so ``bits @ need`` is
``sum_c min(row_count_c, need_count_c, PLANES)`` and a row (or group)
with fewer than ``tot - max_typos`` hits can never pass the positional
prefilter. Fold: ASCII uppercase lowercases, everything else hashes to
``v & 127``; hash collisions only add false positives.
"""

from __future__ import annotations

import numpy as np
import torch

# Multiplicity planes: plane k holds "fold-bit appears >= k+1 times"
PLANES = 3


def _fold_bit(v: torch.Tensor) -> torch.Tensor:
    upper = (v >= 0x41) & (v <= 0x5A)
    return torch.where(upper, v + 0x20, v) & 127


def needle_need_matrix(needles_q: torch.Tensor) -> tuple:
    """(need (PLANES*128, Q) int8, tot (Q,) int32) for the stage-1 matmul.

    ``needles_q`` is (Q, 2n) int32, orig then flip per query. A fold-bit
    is needed when the unit's orig and flip fold to the same bit (ASCII
    always does; unicode case pairs that fold apart are skipped — sound,
    merely weaker)."""
    Q, n2 = needles_q.shape
    n = n2 // 2
    ob = _fold_bit(needles_q[:, :n].to(torch.int32))
    fb = _fold_bit(needles_q[:, n:].to(torch.int32))
    eq = ob == fb  # (Q, n)
    j = torch.arange(128, device=needles_q.device, dtype=torch.int32)
    onehot = (j[None, None, :] == ob[:, :, None]) & eq[:, :, None]
    counts = onehot.to(torch.int32).sum(dim=1)  # (Q, 128)
    need_q = torch.cat(
        [(counts > k).to(torch.int8) for k in range(PLANES)], dim=1
    )  # (Q, PLANES*128)
    tot = need_q.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return need_q.T.contiguous(), tot


def needle_need_matrix_np(needles_q: np.ndarray) -> tuple:
    """Host (NumPy) twin of :func:`needle_need_matrix` — same math. The
    serving dispatcher uses it to choose the static result-sort capacity
    from per-group alive counts before the batch runs."""
    needles_q = np.asarray(needles_q)
    Q, n2 = needles_q.shape
    n = n2 // 2

    def fold(v):
        upper = (v >= 0x41) & (v <= 0x5A)
        return np.where(upper, v + 0x20, v) & 127

    ob, fb = fold(needles_q[:, :n]), fold(needles_q[:, n:])
    # one bincount over every query's needed fold-bits, offset q*128
    keys = (np.arange(Q)[:, None] * 128 + ob)[ob == fb]
    counts = np.bincount(keys, minlength=Q * 128).reshape(Q, 128)
    planes = [(counts > k).astype(np.int8) for k in range(PLANES)]
    need_q = np.concatenate(planes, axis=1)  # (Q, PLANES*128)
    tot = need_q.astype(np.int32).sum(axis=1)
    return need_q.T, tot


def presence_hits(bits: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """(rows, Q) int32 hit counts ``bits @ need`` for 0/1 int8 operands.

    The product runs in float32 with float32 accumulation: every partial
    sum is an integer <= 384, exact whatever the summation order, and the
    0/1 operands are exact even where ``allow_tf32`` rounds inputs to
    TF32. A bf16 accumulator would be exact only to 256. No CUDA integer
    matmul covers these shapes, and an int8 @ int8 CPU matmul returns
    int8, which overflows."""
    return torch.matmul(bits.to(torch.float32), need.to(torch.float32)).to(
        torch.int32
    )


# Per-row presence masks: PLANES planes of 4 int32 words (128 fold-bits)
MASK_WORDS = 4


def presence_mask(cp: torch.Tensor, n_units: torch.Tensor) -> torch.Tensor:
    """(B, PLANES*4) int32 capped-count presence masks of a packed bucket:
    words [4k, 4k+4) hold plane k, bit c set when fold-bit c occurs more
    than k times in the row (bit 31 of a word rides the int32 sign).

    ``cp`` is (B, W) int8 bytes or int32 codepoints, ``n_units`` (B,) or
    (B, 1). The reference's ``presence_mask``."""
    B, W = cp.shape
    u = cp.to(torch.int32)
    if cp.dtype == torch.int8:
        u = u & 0xFF
    col = torch.arange(W, dtype=torch.int32, device=cp.device)[None, :]
    valid = col < n_units.reshape(B, 1)
    # padding columns land in a sentinel bin 128
    v = torch.where(valid, _fold_bit(u), 128).to(torch.int64)
    counts = torch.zeros((B, 129), dtype=torch.int32, device=cp.device)
    counts.scatter_add_(1, v, torch.ones_like(v, dtype=torch.int32))
    bit = torch.arange(32, dtype=torch.int64, device=cp.device)
    words = []
    for plane in range(PLANES):
        on = (counts[:, :128] > plane).to(torch.int64).reshape(
            B, MASK_WORDS, 32)
        w = (on << bit).sum(dim=2)
        words.append(torch.where(w >= (1 << 31), w - (1 << 32), w))
    return torch.cat(words, dim=1).to(torch.int32)


def presence_bits(mask: torch.Tensor) -> torch.Tensor:
    """Expand (B, PLANES*4) int32 masks to the (B, PLANES*128) int8 0/1
    bit matrix of the stage-1 matmul (``PackedBucket
    .device_presence_bits`` builds the same from the host counts)."""
    B = mask.shape[0]
    bit = torch.arange(32, dtype=torch.int32, device=mask.device)
    # (x >> k) & 1 reads bit k whether the shift is arithmetic or not
    bits = (mask[:, :, None] >> bit) & 1
    return bits.reshape(B, PLANES * 128).to(torch.int8)


def stage1_presence(mask: torch.Tensor, needle_packed: torch.Tensor,
                    max_typos: int) -> torch.Tensor:
    """(B,) bool: rows that may still match, missing needle units <= the
    typo budget. Per needle unit, the OR of its orig and flip fold-bits
    (exact for unicode case pairs whose fold-bits differ), read from the
    >= 1-occurrence plane (words 0..3 of :func:`presence_mask`). The
    reference's ``stage1_presence``, the per-row reject of
    ``kernels.fuzzy_match_units``."""
    n = needle_packed.shape[0] // 2
    mask4 = mask[:, :MASK_WORDS]
    units = needle_packed.to(torch.int32).cpu().tolist()

    def present(val):
        v = (val + 0x20 if 0x41 <= val <= 0x5A else val) & 127
        return (mask4[:, v >> 5] >> (v & 31)) & 1

    miss = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    for k in range(n):
        miss = miss + 1 - (present(units[k]) | present(units[n + k]))
    return miss <= int(max_typos)
