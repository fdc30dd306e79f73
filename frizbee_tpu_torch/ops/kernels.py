"""Needle scalar packing shared by the match kernels (the subset of
``frizbee_tpu/ops/kernels.py`` the column-stream path reads)."""

from __future__ import annotations

import torch

# Longest needle the scalar layout holds (the orig/flip pad size)
MAX_KERNEL_NEEDLE = 64

DEFAULT_SCORING = (12, 6, 5, 1, 12, 4, 4, 8, 4)


def pack_needle_scalars(needle_packed: torch.Tensor, count) -> torch.Tensor:
    """[count, n, orig x MAXN, flip x MAXN] int32 per query.

    ``needle_packed`` is (2n,) or (Q, 2n): orig then flip units. The flip
    units start at offset ``2 + MAX_KERNEL_NEEDLE``, not ``2 + n``."""
    n = needle_packed.shape[-1] // 2
    assert n <= MAX_KERNEL_NEEDLE
    lead = needle_packed.shape[:-1]
    out = torch.zeros(
        lead + (2 + 2 * MAX_KERNEL_NEEDLE,), dtype=torch.int32,
        device=needle_packed.device,
    )
    out[..., 0] = int(count)
    out[..., 1] = n
    out[..., 2:2 + n] = needle_packed[..., :n].to(torch.int32)
    out[..., 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n] = (
        needle_packed[..., n:].to(torch.int32)
    )
    return out
