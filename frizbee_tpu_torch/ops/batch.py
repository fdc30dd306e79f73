"""Q-batched single-pattern serving: stage-1 presence, then either the
column-stream flow (fuzzy needles the colstream kernel holds, and every
literal mode) with per-group flags, or the row-major flow (longer fuzzy
needles and larger typo budgets) over per-query survivor orders, and the
top-k finalize — one pass of tensor ops on the corpus device.

Counterpart of ``frizbee_tpu/ops/batch._fused_match_batch_fast``. The
result is the same ``(Q, 1 + fetch_rows, 2)`` int32 array: row 0 is
``[match_count, 0]``, rows 1.. are ``[index, meta]`` with meta =
score<<16 | exact<<15 | greedy<<14 | end_col, best first (score desc,
index asc).

Where JAX branches inside the program (``lax.cond``), this module either
branches on host-known statics or selects on the device with
``torch.where``, so a batch never waits for the device before it is
fully enqueued. The reference's survivor-capacity tiers (1/16, 1/8, 1/4
of a bucket, else every row) are such a device branch; here the kernel
reads each query's survivors through a device-side order and stops at
the device-side count, so one launch at capacity B does the work of
whichever tier the reference takes. The matched rows and the count are
the same on every tier; the rows past the count (sentinel decodes or
zero padding, which no caller reads) are those of the reference's
full-capacity flow.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..corpus import GROUP_ROWS
from .colstream import (
    FUZZY_MODE,
    colstream_literal_supported,
    colstream_supported,
    match_units_colstream,
    row_gather,
)
from .kernels import (
    INT64_MAX,
    MAX_KERNEL_NEEDLE,
    MAX_KERNEL_TYPOS,
    int16_lanes_fit,
    match_units,
    pack_needle_scalars,
)
from .literal import LITERAL_MODES
from .presence import needle_need_matrix, presence_hits

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

# Row-major flows taken, per batch: in_place (no stage-1 reject, every
# row runs) or compacted (each query's stage-1 survivors first; the
# kernel reads only them)
ROW_MAJOR_ROUTES = {"in_place": 0, "compacted": 0}

# Row-major kernel instantiations taken, per bucket launch: int16 lanes
# where the reference's predicate holds (byte rows, score_fits_int16),
# else int32. The record of the choice on CPU tensors, whose plain
# versions count no launch; on the card the launch counters
# (_build.LAUNCHES "match_units_i16" and "match_units") say the same.
ROW_MAJOR_LANES = {"int16": 0, "int32": 0}


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


def unserved_reason(st, nlen: int):
    """None when the batch path serves a single-pattern group of needle
    length ``nlen`` and statics ``st``, else the NotImplementedError
    message naming the slice that ports it. The reference's kernel gate:
    longer needles and larger budgets (and literal needles the colstream
    kernel cannot hold) take its generic pipelines."""
    typos, _nopre, _neg, _sc, mode, _nbl = st
    if nlen > MAX_KERNEL_NEEDLE or min(int(typos), nlen) > MAX_KERNEL_TYPOS:
        return (f"a needle of {nlen} units with max_typos={typos} comes "
                "with the generic pipelines slice")
    if mode != FUZZY_MODE and not colstream_literal_supported(nlen):
        return (f"literal needles of {nlen} units (over 16) come with the "
                "generic pipelines slice")
    return None


def uses_colstream(st, nlen: int) -> bool:
    """Whether a served single-pattern group takes the column-stream flow:
    every literal mode, and fuzzy needles within the colstream kernel's
    needle and typo budgets; the rest take the row-major flow."""
    typos, nopre, _neg, _sc, mode, _nbl = st
    if mode != FUZZY_MODE:
        return True
    return colstream_supported(nlen, min(int(typos), nlen), nopre)


def _serve_keys(keys, *, flags_cat, Q, fetch_rows, finalize_cap, idx_bits,
                idx_mask):
    """(Q, total) int64 keys -> (Q, 1 + fetch_rows, 2) rows: the match
    count, the per-query in-body sort past the batched-sort budget, then
    :func:`_finalize`."""
    counts = (keys != INT64_MAX).sum(dim=1, dtype=torch.int32)
    # int64 keys count as two words against the batched-sort budget
    sort_in_body = Q * keys.shape[1] * 2 > SORT_BODY_BUDGET
    if sort_in_body:
        keys = torch.stack([
            torch.sort(keys[q]).values[:fetch_rows] for q in range(Q)
        ])
    return _finalize(
        keys, counts, presorted=sort_in_body,
        flags_cat=None if sort_in_body else flags_cat,
        Q=Q, fetch_rows=fetch_rows, finalize_cap=finalize_cap,
        idx_bits=idx_bits, idx_mask=idx_mask,
    )


def _survivor_order(s1, nu, W):
    """(Q, B) int32 row order per query: stage-1 survivors first, each
    part by (unit count, row) — one sort of packed [reject | n_units |
    row] keys (``survivor_perms`` in the reference), so survivors of
    similar length share warps."""
    Q, B = s1.shape
    bbits = max((B - 1).bit_length(), 1)
    wbits = W.bit_length()
    # holds for every bucket pack_corpus builds (corpus.max_bucket_rows)
    assert bbits + wbits + 1 <= 31, (B, W)
    iota = torch.arange(B, dtype=torch.int32, device=s1.device)
    keyb = (nu << bbits) | iota
    key = torch.where(s1, keyb, keyb | (1 << (bbits + wbits)))
    # a transposed mask carries its strides through where and sort
    return (torch.sort(key, dim=1).values & ((1 << bbits) - 1)).contiguous()


def _row_major_flow(bits8, buckets_rm, needles_q, *, T, no_prefilter,
                    scoring, use_stage1, fetch_rows, idx_bits, idx_mask):
    """The row-major route: one ``match_units`` launch per bucket for all
    Q queries, in key-emit mode. With stage 1, each query's live count is
    its survivor count (written into the scalars on the device) and the
    kernel reads rows through the survivor order; without, every row
    runs in bucket order. Each bucket takes the int16-lane instantiation
    where ``kernels.int16_lanes_fit`` holds, as the reference's serving
    path does (``int16_lanes=(not unicode) and score_fits_int16``)."""
    Q, n2 = needles_q.shape
    nlen = n2 // 2
    scal = pack_needle_scalars(needles_q, 0)
    if use_stage1:
        need, tot = needle_need_matrix(needles_q)
        thresh = tot - T
        surv = torch.zeros((), dtype=torch.int64, device=needles_q.device)
    keys = []
    for bits, (cp, nu, idx) in zip(bits8, buckets_rm):
        B, W = cp.shape
        sc = scal.clone()
        order = None
        if use_stage1:
            s1 = (presence_hits(bits, need) >= thresh[None, :]).T
            cnt = s1.sum(dim=1, dtype=torch.int32)
            sc[:, 0] = cnt
            surv = surv + cnt.sum()
            order = _survivor_order(s1, nu, W)
        else:
            sc[:, 0] = B
        int16 = int16_lanes_fit(cp.dtype != torch.int8, scoring, nlen, W)
        ROW_MAJOR_LANES["int16" if int16 else "int32"] += 1
        keys.append(match_units(
            cp, nu, sc, order, idx, n=nlen, max_typos=T, scoring=scoring,
            no_prefilter=no_prefilter, idx_bits=idx_bits, int16_lanes=int16,
        ))
    ROW_MAJOR_ROUTES["compacted" if use_stage1 else "in_place"] += 1
    out = _serve_keys(
        torch.cat(keys, dim=1), flags_cat=None, Q=Q, fetch_rows=fetch_rows,
        finalize_cap=None, idx_bits=idx_bits, idx_mask=idx_mask,
    )
    if use_stage1:
        # no query has a stage-1 survivor: the all-zero result
        out = torch.where(surv == 0, torch.zeros_like(out), out)
    return out


def fused_match_sorted_batch(
    bits8,  # per bucket PackedBucket.device_presence_bits()
    stacked_patterns,  # one (orig (Q,n), flip (Q,n), sc (Q,9)) per pattern
    *,
    n: int,  # corpus rows (sets the key's index width)
    pattern_statics: Tuple,  # (typos, no_prefilter, negated, scoring, mode, nbl)
    fetch_rows: int,
    buckets,  # the corpus's PackedBuckets, each at most 1024 wide
    finalize_cap=None,  # host-chosen (cap_blocks, n_sel), or None
):
    """Serve Q shape-uniform single-pattern queries against one resident
    corpus: (Q, 1 + fetch_rows, 2) int32 on the corpus device.

    :func:`uses_colstream` picks the flow: the colstream flow reads each
    bucket's ``device_arrays_colstream()`` (with the ctx plane of a
    unicode bucket; it takes ``finalize_cap``), the row-major flow its
    ``device_arrays_rowmajor()`` (bytes, or the codepoints of a unicode
    bucket). Queries outside
    :func:`unserved_reason` raise NotImplementedError naming the slice
    that ports them."""
    if len(pattern_statics) != 1 or pattern_statics[0][2]:
        raise NotImplementedError(
            "multi-pattern and negated queries come with the "
            "multi-pattern serving slice"
        )
    st = pattern_statics[0]
    typos, no_prefilter, _neg, scoring, mode, nbl = st
    literal = mode != FUZZY_MODE
    if literal and mode not in LITERAL_MODES:
        raise ValueError(f"unknown match mode {mode!r}")
    orig_q, flip_q, _sc = stacked_patterns[0]
    Q, nlen = orig_q.shape
    reason = unserved_reason(st, nlen)
    if reason is not None:
        raise NotImplementedError(reason)
    # literal matching ignores the typo budget: its stage-1 presence
    # reject runs at T=0, sound a fortiori for contiguous runs
    T = 0 if literal else min(int(typos), nlen)
    use_stage1 = nlen > 0 if literal else (not no_prefilter and nlen > T)
    idx_bits = max((n - 1).bit_length(), 1)
    idx_mask = (1 << idx_bits) - 1
    needles_q = torch.cat([orig_q, flip_q], dim=1).to(torch.int32)
    dev = needles_q.device

    if not bits8:
        return torch.zeros((Q, 1 + fetch_rows, 2), dtype=torch.int32,
                           device=dev)
    if not uses_colstream(st, nlen):
        return _row_major_flow(
            bits8, [b.device_arrays_rowmajor() for b in buckets],
            needles_q,
            T=T, no_prefilter=no_prefilter, scoring=scoring,
            use_stage1=use_stage1, fetch_rows=fetch_rows,
            idx_bits=idx_bits, idx_mask=idx_mask,
        )
    buckets_T = [b.device_arrays_colstream() for b in buckets]

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
        cpT, nuT, idxT, blk_bits, ctxT = bt
        W = cpT.shape[0] // blk_bits.shape[0]
        keys.append(match_units_colstream(
            cpT, nuT, pack_needle_scalars(needles_q, bits.shape[0]),
            flags_T[bi] if flags_T is not None else None, idxT, ctxT,
            W=W, n=nlen, max_typos=T, scoring=scoring,
            no_prefilter=no_prefilter, idx_bits=idx_bits, mode=mode,
            needle_byte_len=nbl,
        ))
    out = _serve_keys(
        torch.cat(keys, dim=1),
        flags_cat=(torch.cat(flags_T, dim=1) if flags_T is not None
                   else None),
        Q=Q, fetch_rows=fetch_rows, finalize_cap=finalize_cap,
        idx_bits=idx_bits, idx_mask=idx_mask,
    )
    if empty is not None:
        # no query has a stage-1 survivor: the all-zero result
        out = torch.where(empty, torch.zeros_like(out), out)
    return out
