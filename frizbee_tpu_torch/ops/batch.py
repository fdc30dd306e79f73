"""Q-batched single-pattern fuzzy serving over the column-stream kernel:
stage-1 presence, per-group flags, the in-place flow and the top-k
finalize, in one pass of tensor ops on the corpus device.

Counterpart of the in-place flow of
``frizbee_tpu/ops/batch._fused_match_batch_fast``. The result is the same
``(Q, 1 + fetch_rows, 2)`` int32 array: row 0 is ``[match_count, 0]``,
rows 1.. are ``[index, meta]`` with meta = score<<16 | exact<<15 |
greedy<<14 | end_col, best first (score desc, index asc).

Where JAX branches inside the program (``lax.cond``), this module either
branches on host-known statics or selects on the device with
``torch.where``, so a batch never waits for the device before it is
fully enqueued.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..corpus import GROUP_ROWS
from .colstream import (
    INT64_MAX,
    colstream_supported,
    match_units_colstream,
    row_gather,
)
from .kernels import pack_needle_scalars
from .presence import needle_need_matrix, presence_hits

FUZZY_MODE = "fuzzy"

# Batched result sorts keep Q x total keys; past this total-element budget
# (int64 keys count as two words) each query's keys sort and slice on
# their own. Module constant so tests can force the per-query path.
SORT_BODY_BUDGET = 1 << 29

# Broad-needle result selection: R slots per tournament block
BROAD_TOPK_R = 128

# Finalize routes taken, per batch (capped/mixed/broad/full/presorted)
FINALIZE_ROUTES = {
    "capped": 0, "mixed": 0, "broad": 0, "full": 0, "presorted": 0,
}


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _decode_keys(k64, idx_bits, idx_mask):
    """[index, meta] int32 from sorted int64 keys. Shifts are logical:
    every key is non-negative, and the masks keep that explicit."""
    inv16 = (k64 >> (idx_bits + 16)) & 0xFFFF
    score = (0xFFFF - inv16) & 0xFFFF
    index = ((k64 >> 16) & idx_mask).to(torch.int32)
    meta = _to_int32((score << 16) | (k64 & 0xFFFF))
    return index, meta


def _broad_topk_ok(total, fetch_rows):
    """Gate for the tournament: total % R == 0, at least fetch_rows
    blocks, and a gathered candidate set no more than half the width."""
    R = BROAD_TOPK_R
    return (
        total % R == 0
        and fetch_rows <= total // R
        and 2 * fetch_rows * R <= total
    )


def _broad_topk(keys, *, fetch_rows):
    """Exact top-``fetch_rows`` smallest int64 keys per query of (Q, total)
    without the full-width sort: a block-min tournament. Valid keys are
    unique (they embed the row index), so the S smallest R-slot block
    minima hold every top-S key; those blocks are gathered (int64 keys
    viewed as int32 pairs, one 256-word row per block) and sorted."""
    Q, total = keys.shape
    R = BROAD_TOPK_R
    NB = total // R
    S = min(fetch_rows, NB)
    bm = keys.reshape(Q, NB, R).amin(dim=2)
    sel = torch.argsort(bm, dim=1)[:, :S].to(torch.int32)
    qbase = (torch.arange(Q, device=keys.device, dtype=torch.int32)
             * NB)[:, None]
    flat = keys.contiguous().view(torch.int32).reshape(Q * NB, 2 * R)
    g = row_gather(flat, (qbase + sel).reshape(-1))
    gk = g.view(torch.int64).reshape(Q, S * R)
    return torch.sort(gk, dim=1).values[:, :fetch_rows]


def _finalize(keys, counts, *, presorted, flags_cat, Q, fetch_rows,
              finalize_cap, idx_bits, idx_mask):
    """Top-``fetch_rows`` keys per query -> (Q, 1+fetch_rows, 2) rows.

    Routes: presorted (the per-query in-body sort already ran); capped
    (the host-chosen ``finalize_cap`` = (cap_blocks, n_sel): queries
    [0:n_sel] gather their alive groups to the front and sort only
    cap_blocks groups; the rest take the broad tournament or the full
    sort — the mixed split); broad tournament; full sort."""
    total = keys.shape[1]
    if flags_cat is not None:
        # a fetch window approaching half the corpus leaves nothing
        # for the capped tiers to cut — take the plain full sort
        if -(-fetch_rows // GROUP_ROWS) + 1 >= -(-flags_cat.shape[1] // 2):
            flags_cat = None
    if presorted:
        FINALIZE_ROUTES["presorted"] += 1
        kc = keys
    elif flags_cat is not None and finalize_cap:
        cap_blocks, n_sel = finalize_cap
        n_sel = min(n_sel, Q)
        nGtot = flags_cat.shape[1]
        cap_blocks = min(cap_blocks, nGtot)
        FINALIZE_ROUTES["capped" if n_sel == Q else "mixed"] += 1
        parts = []
        if n_sel > 0:
            # the dispatcher guarantees every selective query's alive
            # groups fit cap_blocks (and cap_blocks * 1024 > fetch_rows),
            # so dropping the tail is exact
            order = torch.argsort(
                1 - flags_cat[:n_sel], dim=1, stable=True
            )[:, :cap_blocks].to(torch.int32)
            qbase = (torch.arange(n_sel, device=keys.device,
                                  dtype=torch.int32) * nGtot)[:, None]
            groups = keys[:n_sel].view(torch.int32).reshape(
                n_sel * nGtot, 2 * GROUP_ROWS
            )
            sel = row_gather(groups, (qbase + order).reshape(-1)).view(
                torch.int64
            ).reshape(n_sel, cap_blocks * GROUP_ROWS)
            parts.append(torch.sort(sel, dim=1).values[:, :fetch_rows])
        if n_sel < Q:
            if _broad_topk_ok(total, fetch_rows):
                kc_b = _broad_topk(keys[n_sel:], fetch_rows=fetch_rows)
            else:
                kc_b = torch.sort(keys[n_sel:], dim=1).values[:, :fetch_rows]
            parts.append(kc_b)
        kc = parts[0] if len(parts) == 1 else torch.cat(parts)
    elif _broad_topk_ok(total, fetch_rows):
        FINALIZE_ROUTES["broad"] += 1
        kc = _broad_topk(keys, fetch_rows=fetch_rows)
    else:
        FINALIZE_ROUTES["full"] += 1
        kc = torch.sort(keys, dim=1).values
    kc = kc[:, :fetch_rows]
    index, metas = _decode_keys(kc, idx_bits, idx_mask)
    rows = torch.stack([index, metas], dim=2)
    if rows.shape[1] < fetch_rows:
        rows = torch.cat([rows, torch.zeros(
            (Q, fetch_rows - rows.shape[1], 2), dtype=torch.int32,
            device=rows.device,
        )], dim=1)
    header = torch.stack([counts, torch.zeros_like(counts)], dim=1)
    return torch.cat([header[:, None, :], rows], dim=1)


def fused_match_sorted_batch(
    bits8,  # per bucket PackedBucket.device_presence_bits()
    stacked_patterns,  # one (orig (Q,n), flip (Q,n), sc (Q,9)) per pattern
    *,
    n: int,  # corpus rows (sets the key's index width)
    pattern_statics: Tuple,  # (typos, no_prefilter, negated, scoring, mode, nbl)
    fetch_rows: int,
    buckets_T,  # per bucket device_arrays_colstream()
    finalize_cap=None,  # host-chosen (cap_blocks, n_sel), or None
):
    """Serve Q shape-uniform single-pattern fuzzy queries against one
    resident corpus: (Q, 1 + fetch_rows, 2) int32 on the corpus device.

    The slice serves the in-place flow only: every bucket is at most
    1024 wide and the needle fits the column-stream kernel. Other
    routes raise NotImplementedError naming the slice that ports them."""
    if len(pattern_statics) != 1 or pattern_statics[0][2]:
        raise NotImplementedError(
            "multi-pattern and negated queries come with the "
            "multi-pattern serving slice"
        )
    typos, no_prefilter, _neg, scoring, mode, _nbl = pattern_statics[0]
    if mode != FUZZY_MODE:
        raise NotImplementedError(
            "literal modes come with the literal serving slice"
        )
    orig_q, flip_q, _sc = stacked_patterns[0]
    Q, nlen = orig_q.shape
    T = min(int(typos), nlen)
    if not colstream_supported(nlen, T, no_prefilter):
        raise NotImplementedError(
            f"needle of {nlen} units with typo budget {T} needs the "
            "row-major route (kernel #4), a later slice"
        )
    use_stage1 = (not no_prefilter) and nlen > T
    idx_bits = max((n - 1).bit_length(), 1)
    idx_mask = (1 << idx_bits) - 1
    needles_q = torch.cat([orig_q, flip_q], dim=1).to(torch.int32)
    dev = needles_q.device

    if not bits8:
        return torch.zeros((Q, 1 + fetch_rows, 2), dtype=torch.int32,
                           device=dev)

    total = sum(bt[2].shape[0] for bt in buckets_T)
    # int64 keys count as two words against the batched-sort budget
    sort_in_body = Q * total * 2 > SORT_BODY_BUDGET

    flags_T = None
    empty = None
    if use_stage1:
        # P1a: stage-1 survivor counts (only "does any row survive")
        need, tot = needle_need_matrix(needles_q)
        thresh = tot - T
        surv = torch.zeros((), dtype=torch.int64, device=dev)
        for bits in bits8:
            surv = surv + (presence_hits(bits, need)
                           >= thresh[None, :]).sum()
        empty = surv == 0
        # per-group flags: the same matmul over group-max planes
        flags_T = [
            (presence_hits(bt[3], need) >= thresh[None, :]).T.to(
                torch.int32
            ).contiguous()
            for bt in buckets_T
        ]

    # in-place flow: one kernel launch per bucket covers all Q queries
    keys = []
    for bi, (bits, bt) in enumerate(zip(bits8, buckets_T)):
        cpT, nuT, idxT, blk_bits = bt
        W = cpT.shape[0] // blk_bits.shape[0]
        keys.append(match_units_colstream(
            cpT, nuT, pack_needle_scalars(needles_q, bits.shape[0]),
            flags_T[bi] if flags_T is not None else None, idxT,
            W=W, n=nlen, max_typos=T, scoring=scoring,
            no_prefilter=no_prefilter, idx_bits=idx_bits,
        ))
    keys = torch.cat(keys, dim=1)
    counts = (keys != INT64_MAX).sum(dim=1, dtype=torch.int32)
    if sort_in_body:
        keys = torch.stack([
            torch.sort(keys[q]).values[:fetch_rows] for q in range(Q)
        ])
    out = _finalize(
        keys, counts, presorted=sort_in_body,
        flags_cat=(
            torch.cat(flags_T, dim=1)
            if flags_T is not None and not sort_in_body else None
        ),
        Q=Q, fetch_rows=fetch_rows, finalize_cap=finalize_cap,
        idx_bits=idx_bits, idx_mask=idx_mask,
    )
    if empty is not None:
        # no query has a stage-1 survivor: the all-zero result
        out = torch.where(empty, torch.zeros_like(out), out)
    return out
