"""Q-batched serving: stage-1 presence, then either the column-stream
flow (fuzzy needles the colstream kernel holds, and literal needles of
up to 16 units) with per-group flags, or the row-major flow (longer
fuzzy needles and larger typo budgets) over per-query survivor orders,
and the top-k finalize — one pass of tensor ops on the corpus device.
Multi-pattern and negated queries take the multi flow: every pattern's
colstream kernel in columns mode over the same flag-gated blocks, then
the combine (scores sum, exact and greedy OR, end_col max, negation
veto). The rest take the generic routes: the generic body (index sorts,
atoms beyond the colstream budgets, and everything the kernels do not
hold: its fuzzy atoms run ``kernels.fuzzy_match_units`` where they fit
the row-major kernel, else the plain fuzzy and literal pipelines of
``ops/fuzzy`` and ``ops/literal``), and the literal fast path for single
literal needles over 16 units.

Counterpart of ``frizbee_tpu/ops/batch.py``: ``fused_match_sorted_batch``
routes as the reference's does, and the result is the same ``(Q, 1 +
fetch_rows, 2)`` int32 array: row 0 is ``[match_count, 0]``, rows 1..
are ``[index, meta]`` with meta = score<<16 | exact<<15 | greedy<<14 |
end_col, best first (score desc, index asc), or by index under an index
sort.

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
from .fuzzy import fuzzy_pipeline
from .kernels import (
    INT64_MAX,
    _survivor_order,
    fuzzy_match_units,
    int16_lanes_dispatch,
    match_units,
    pack_keys,
    pack_needle_scalars,
)
from .literal import (
    LITERAL_MODES,
    ascii_planes,
    literal_context,
    literal_match_ctx,
    units_planes,
)
from .presence import needle_need_matrix, presence_hits

# Batched result sorts keep Q x total keys; past this total-element budget
# (int64 keys count as two words) each query's keys sort and slice on
# their own. Module constant so tests can force the per-query path.
SORT_BODY_BUDGET = 1 << 29

INT32_MAX = (1 << 31) - 1

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

# Column-stream flows taken, per batch: single (one non-negated pattern,
# key-emit launches) or multi (several patterns or a negated one,
# columns-mode launches and the combine)
COLSTREAM_FLOWS = {"single": 0, "multi": 0}

# Row-major kernel instantiations taken, per bucket launch: int16 lanes
# where kernels.int16_lanes_dispatch holds (byte rows, score_fits_int16,
# and the CPU, or the card while INT16_CUDA_OK), else int32. The record of
# the choice on CPU tensors, whose plain versions count no launch; on the
# card the launch counters (_build.LAUNCHES "match_units_i16" and
# "match_units") say the same.
ROW_MAJOR_LANES = {"int16": 0, "int32": 0}

# Generic routes taken, per batch: kernel_body (the generic body over
# the kernels' row arrays: fuzzy atoms through kernels.fuzzy_match_units,
# literal atoms through the literal pipelines — index sorts and
# multi-pattern atoms beyond the column-stream budgets), pipeline_body
# (the generic body over PackedBucket.device_arrays(): needles over 64
# units, budgets over 8, bucket widths the kernels do not hold) and
# literal_fast (single literal needles over 16 units)
GENERIC_ROUTES = {"kernel_body": 0, "pipeline_body": 0, "literal_fast": 0}


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _keys_from_cols(matched, score, exact, end_col, greedy, idx, idx_bits):
    """Result columns -> (int64 keys, match count): the layout the
    colstream kernel's key-emit mode writes (``kernels.pack_keys``), so
    ascending order is (matched first, score desc, index asc); unmatched
    and padding rows (idx < 0) carry INT64_MAX."""
    keys = pack_keys(matched, score, exact, end_col, greedy, idx, idx_bits)
    return keys, (keys != INT64_MAX).sum(dtype=torch.int32)


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


def _broad_topk(keys, *, fetch_rows, R=BROAD_TOPK_R):
    """Exact top-``fetch_rows`` smallest int64 keys per query of (Q, total)
    without the full-width sort: a block-min tournament. Valid keys are
    unique (they embed the row index), so the S smallest R-slot block
    minima hold every top-S key; those blocks are gathered (int64 keys
    viewed as int32 pairs, one 2R-word row per block) and sorted. Serving
    takes R = BROAD_TOPK_R; ``probes/broad_topk.py`` times 64 and 128."""
    Q, total = keys.shape
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


def uses_colstream(st, nlen: int) -> bool:
    """Whether a single-pattern group of the kernel routes takes the
    column-stream flow: literal needles within the literal kernel's
    budget, and fuzzy needles within the fuzzy kernel's needle and typo
    budgets. Other fuzzy needles take the row-major flow, other literal
    needles ``_fused_literal_batch_fast``."""
    typos, nopre, _neg, _sc, mode, _nbl = st
    if mode != FUZZY_MODE:
        return colstream_literal_supported(nlen)
    return colstream_supported(nlen, min(int(typos), nlen), nopre)


def colstream_eligible_all(pattern_statics, needle_lens) -> bool:
    """True when every pattern of a group fits the column-stream kernels
    (a fuzzy needle within their needle and typo budgets, or a literal
    needle within the literal kernel's): the gate of the multi flow,
    shared with the dispatcher so routing and the cap chooser agree."""
    for st, ln in zip(pattern_statics, needle_lens):
        typos, nopre, _neg, _sc, mode, _nbl = st
        if ln < 1:
            return False
        if mode == FUZZY_MODE:
            if not colstream_supported(ln, min(int(typos), ln), nopre):
                return False
        elif mode in LITERAL_MODES:
            if not colstream_literal_supported(ln):
                return False
        else:
            return False
    return True


def _pattern_s1_contributes(st, nlen) -> bool:
    """Whether a pattern's stage-1 flags narrow the combined group-alive
    set: non-negated, and its prefilter rejects (literal always can, at
    T=0; fuzzy needs a budget below the needle length). The host cap
    chooser (``matcher._colstream_blocks_and_cap``) reads the same
    predicate: the static cap is sound only while host and device compute
    the same alive sets."""
    typos, nopre, neg, _sc, mode, _nbl = st
    if neg:
        return False
    if mode != FUZZY_MODE:
        return nlen > 0
    T = min(int(typos), nlen)
    return (not nopre) and nlen > T


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


def _row_major_flow(bits8, buckets_rm, needles_q, *, T, no_prefilter,
                    scoring, use_stage1, fetch_rows, idx_bits, idx_mask):
    """The row-major route: one ``match_units`` launch per bucket for all
    Q queries, in key-emit mode. With stage 1, each query's live count is
    its survivor count (written into the scalars on the device) and the
    kernel reads rows through the survivor order; without, every row
    runs in bucket order. Each bucket takes the int16-lane instantiation
    where ``kernels.int16_lanes_dispatch`` holds, as the reference's
    serving path does (``(not unicode) and score_fits_int16(...) and
    (interpret or INT16_MOSAIC_OK)``): on CPU tensors where the rows fit,
    and on the card where they fit while ``kernels.INT16_CUDA_OK`` is set
    (it is: the int16 kernel won the card's A/B)."""
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
        int16 = int16_lanes_dispatch(cp.device, cp.dtype != torch.int8,
                                     scoring, nlen, W)
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


def _fused_multi_batch_fast(bits8, buckets, stacked_patterns, *, n,
                            pattern_statics, fetch_rows, finalize_cap=None):
    """Multi-pattern (or single negated) serving over the column-stream
    kernels. The per-group alive flags are the AND of every contributing
    pattern's stage-1 flags (:func:`_pattern_s1_contributes`): a group
    dead for any of them holds no combined match. Each (pattern, bucket)
    launches once for all Q queries in columns mode over those flags, and
    its five columns fold into the combined state before the next launch
    (reference: src/matcher/multi.rs:84-152): a non-negated pattern ANDs
    into matched, adds its score (saturating at 0xFFFF), ORs exact and
    greedy and takes the larger end_col; a negated one vetoes. The keys
    then take the single flow's finalize."""
    Q = stacked_patterns[0][0].shape[0]
    idx_bits = max((n - 1).bit_length(), 1)
    idx_mask = (1 << idx_bits) - 1
    dev = stacked_patterns[0][0].device
    COLSTREAM_FLOWS["multi"] += 1
    if not bits8:
        return torch.zeros((Q, 1 + fetch_rows, 2), dtype=torch.int32,
                           device=dev)
    buckets_T = [b.device_arrays_colstream() for b in buckets]

    infos = []
    for (orig_q, flip_q, _sc), st in zip(stacked_patterns, pattern_statics):
        typos, nopre, neg, scoring, mode, nbl = st
        nlen = orig_q.shape[1]
        infos.append(dict(
            needles=torch.cat([orig_q, flip_q], dim=1).to(torch.int32),
            T=0 if mode != FUZZY_MODE else min(int(typos), nlen),
            mode=mode, nbl=nbl, scoring=scoring, neg=neg, nopre=nopre,
            nlen=nlen, s1=_pattern_s1_contributes(st, nlen),
        ))

    flags_T = None
    if any(i["s1"] for i in infos):
        needs = [(needle_need_matrix(i["needles"]), i["T"])
                 for i in infos if i["s1"]]
        flags_T = []
        for bt in buckets_T:
            alive = None
            for (need, tot), t in needs:
                ok = presence_hits(bt[3], need) >= (tot - t)[None, :]
                alive = ok if alive is None else alive & ok
            flags_T.append(alive.T.to(torch.int32).contiguous())

    keys = []
    for bi, (bits, bt) in enumerate(zip(bits8, buckets_T)):
        cpT, nuT, idxT, blk_bits, ctxT = bt
        W = cpT.shape[0] // blk_bits.shape[0]
        fl = flags_T[bi] if flags_T is not None else None
        idx = idxT.reshape(1, -1)
        cm = (idx >= 0).expand(Q, -1)
        cs = torch.zeros(cm.shape, dtype=torch.int32, device=dev)
        ce = torch.zeros(cm.shape, dtype=torch.bool, device=dev)
        cec = torch.zeros_like(cs)
        cg = torch.zeros_like(ce)
        for info in infos:
            m, s, e, ec, g = match_units_colstream(
                cpT, nuT, pack_needle_scalars(info["needles"], bits.shape[0]),
                fl, None, ctxT, W=W, n=info["nlen"], max_typos=info["T"],
                scoring=info["scoring"], no_prefilter=info["nopre"],
                mode=info["mode"], needle_byte_len=info["nbl"],
            )
            mb = m > 0
            if info["neg"]:
                cm = cm & ~mb
            else:
                cm = cm & mb
                cs = torch.clamp(cs + torch.where(mb, s, 0), max=0xFFFF)
                ce = ce | ((e > 0) & mb)
                cec = torch.maximum(cec, torch.where(mb, ec, 0))
                cg = cg | ((g > 0) & mb)
        keys.append(_keys_from_cols(cm, cs, ce, cec, cg, idx, idx_bits)[0])
    return _serve_keys(
        torch.cat(keys, dim=1),
        flags_cat=(torch.cat(flags_T, dim=1) if flags_T is not None
                   else None),
        Q=Q, fetch_rows=fetch_rows, finalize_cap=finalize_cap,
        idx_bits=idx_bits, idx_mask=idx_mask,
    )


def _fused_match_batch_fast(bits8, buckets, pattern, *, n, statics,
                            fetch_rows, finalize_cap=None):
    """Q-batched single-pattern serving over the kernels: the colstream
    flow (fuzzy needles the colstream kernel holds, and literal needles
    of up to 16 units) with per-group stage-1 flags and the finalize,
    or the row-major flow (longer fuzzy needles and larger budgets) over
    per-query survivor orders. The reference's ``_fused_match_batch_fast``
    (with its column-stream literal twin)."""
    typos, no_prefilter, _neg, scoring, mode, nbl = statics
    literal = mode != FUZZY_MODE
    if literal and mode not in LITERAL_MODES:
        raise ValueError(f"unknown match mode {mode!r}")
    orig_q, flip_q, _sc = pattern
    Q, nlen = orig_q.shape
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
    if not uses_colstream(statics, nlen):
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
    COLSTREAM_FLOWS["single"] += 1
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


def order_keys(matched, score, index):
    """(primary, secondary) ascending-sort keys realizing (matched first,
    score desc, index asc); unmatched rows sort last as (1, INT32_MAX).
    Shared with the sharded top-k so the two orders cannot diverge."""
    neg_score = torch.where(matched, -score, 1)
    idx = torch.where(matched, index, INT32_MAX)
    return neg_score.to(torch.int32), idx.to(torch.int32)


def _pack_meta(score, exact, greedy, end_col):
    """meta word: score<<16 | exact<<15 | greedy<<14 | end_col (14 bits),
    int32 (a score of 0x8000 or more rides the sign bit)."""
    meta = (
        ((score.to(torch.int64) & 0xFFFF) << 16)
        | (exact.to(torch.int64) << 15)
        | (greedy.to(torch.int64) << 14)
        | torch.clamp(end_col.to(torch.int64), max=0x3FFF)
    )
    return _to_int32(meta & 0xFFFFFFFF)


def _select_sorted(matched, score, exact, end_col, greedy, index, n,
                   score_bound, sort_by_score):
    """(count, rows): the match count and [index, meta] int32 rows with
    every match first in the configured order, through one packed int64
    sort key — by score: -((score << idx_bits) | (idx_mask - index)) << 16
    | meta_low16; by index: index << 32 | meta_u32. Ascending order
    realizes the configured total order; unmatched rows carry INT64_MAX
    and decode (past the count) to the reference's bit patterns. The
    columns are (B,) or (Q, B); ``score_bound`` is unused, as in the
    reference."""
    count = matched.sum(dim=-1, dtype=torch.int32)
    B = matched.shape[-1]
    if B == 0:
        return count, torch.zeros(matched.shape[:-1] + (0, 2),
                                  dtype=torch.int32, device=matched.device)
    meta = _pack_meta(score, exact, greedy, end_col).to(torch.int64)
    idx_bits = max((n - 1).bit_length(), 1)
    idx_mask = (1 << idx_bits) - 1
    index = index.to(torch.int64)
    if sort_by_score:
        comp = (score.to(torch.int64) << idx_bits) | (idx_mask - index)
        k64 = ((-comp) << 16) | (meta & 0xFFFF)
    else:
        k64 = (index << 32) | (meta & 0xFFFFFFFF)
    k = torch.sort(torch.where(matched, k64, INT64_MAX), dim=-1).values
    if sort_by_score:
        comp2 = -(k >> 16)
        # logical shift: the sentinel's comp2 is negative
        score2 = (comp2 >> idx_bits) & ((1 << (64 - idx_bits)) - 1)
        i2 = _to_int32((idx_mask - (comp2 & idx_mask)) & 0xFFFFFFFF)
        m2 = _to_int32(((score2 & 0xFFFFFFFF) << 16 | (k & 0xFFFF))
                       & 0xFFFFFFFF)
    else:
        i2 = _to_int32((k >> 32) & 0xFFFFFFFF)
        m2 = _to_int32(k & 0xFFFFFFFF)
    return count, torch.stack([i2, m2], dim=-1)


def _bucket_pattern_result(bucket, pattern, statics, *, use_kernel,
                           bits=None):
    """One pattern over one bucket for every query of a group: (matched,
    score, exact, end_col, greedy), each (Q, B). With ``use_kernel``, a
    fuzzy atom runs :func:`kernels.fuzzy_match_units` (one
    ``match_units`` launch for all Q queries, stage 1 from the bucket's
    presence planes ``bits``) and a literal atom the literal pipeline
    over context derived from the kernels' rows; without, the fuzzy and
    literal pipelines run over ``PackedBucket.device_arrays()``, a query
    at a time. The needle-independent literal context is computed once a
    bucket."""
    typos, nopre, _neg, scoring, mode, nbl = statics
    orig_q, flip_q, _sc = pattern
    Q, nlen = orig_q.shape
    if mode == FUZZY_MODE and use_kernel:
        cp, nu, _idx = bucket.device_arrays_rowmajor()
        needles = torch.cat([orig_q, flip_q], dim=1).to(torch.int32)
        T = min(int(typos), nlen)
        s1 = None
        if bits is not None and not nopre and nlen > T:
            need, tot = needle_need_matrix(needles)
            s1 = (presence_hits(bits, need) >= (tot - T)[None, :]).T
        return fuzzy_match_units(
            cp, nu, needles, max_typos=T, no_prefilter=nopre,
            scoring=scoring, survivors=s1)
    if mode == FUZZY_MODE:
        arrays = bucket.device_arrays()[:7]
        cols = [fuzzy_pipeline(*arrays, orig_q[q], flip_q[q], scoring,
                               max_typos=typos, no_prefilter=nopre)[:5]
                for q in range(Q)]
        return tuple(torch.stack(c) for c in zip(*cols))
    if mode not in LITERAL_MODES:
        raise ValueError(f"unknown match mode {mode!r}")
    if use_kernel:
        cp_k, nu, _idx = bucket.device_arrays_rowmajor()
        if bucket.unicode:
            cp, first, prev, boff, _blen, n_bytes = units_planes(cp_k, nu)
        else:
            cp, first, prev, boff, n_bytes = ascii_planes(cp_k, nu)
    else:
        cp, first, prev, boff, _blen, nu, n_bytes, _idx = (
            bucket.device_arrays())
    B, W = cp.shape
    zeros = torch.zeros((Q, B), dtype=torch.int32, device=cp.device)
    false = torch.zeros((Q, B), dtype=torch.bool, device=cp.device)
    if nlen == 0 or nlen > W:
        return false, zeros, false, zeros, false
    ctx = literal_context(first, prev, boff, nu, n=nlen, W=W,
                          scoring=scoring)
    cols = [literal_match_ctx(
        ctx, cp, nu, n_bytes, boff, orig_q[q], flip_q[q], mode=mode,
        needle_byte_len=nbl, scoring=scoring) for q in range(Q)]
    m, sc, e, ec = (torch.stack(c) for c in zip(*cols))
    return m, sc, e, ec, false


def _fused_match_body(bits8, buckets, stacked_patterns, *, n,
                      pattern_statics, sort_by_score, use_kernel,
                      fetch_rows):
    """The generic body for Q queries: per bucket, every pattern's
    columns (:func:`_bucket_pattern_result`) fold into the combined
    state —
    non-negated atoms AND into matched, add their score (saturating at
    0xFFFF), OR exact and greedy and take the larger end_col; negated
    atoms veto (reference: src/matcher/multi.rs:84-152); size-class
    padding rows (index -1) never match — then :func:`_select_sorted`
    over the concatenated buckets. Returns (Q, 1 + min(total,
    fetch_rows), 2): the reference's scan over queries, one query's body
    per step, each sliced to ``fetch_rows`` rows after the header."""
    Q = stacked_patterns[0][0].shape[0]
    dev = stacked_patterns[0][0].device
    parts = []
    for bi, b in enumerate(buckets):
        if use_kernel:
            idx = b.device_arrays_rowmajor()[2]
        else:
            idx = b.device_arrays()[7]
        cm = (idx >= 0)[None, :].expand(Q, -1)
        cs = torch.zeros(cm.shape, dtype=torch.int32, device=dev)
        ce = torch.zeros(cm.shape, dtype=torch.bool, device=dev)
        cec = torch.zeros_like(cs)
        cg = torch.zeros_like(ce)
        for pat, st in zip(stacked_patterns, pattern_statics):
            m, sc, e, ec, g = _bucket_pattern_result(
                b, pat, st, use_kernel=use_kernel,
                bits=bits8[bi] if bits8 else None)
            if st[2]:  # negated
                cm = cm & ~m
            else:
                cm = cm & m
                cs = torch.clamp(cs + torch.where(m, sc, 0), max=0xFFFF)
                ce = ce | (e & m)
                cec = torch.maximum(cec, torch.where(m, ec, 0))
                cg = cg | (g & m)
        parts.append((cm, cs, ce, cec, cg, idx[None, :].expand(Q, -1)))
    if not parts:  # every row XL (or an empty corpus): no device rows
        z = torch.zeros((Q, 0), dtype=torch.int32, device=dev)
        parts = [(z.bool(), z, z.bool(), z, z.bool(), z)]
    cols = [torch.cat([p[i] for p in parts], dim=1) for i in range(6)]
    total = cols[0].shape[1]
    if Q * total * 2 > SORT_BODY_BUDGET:
        res = [_select_sorted(*(c[q] for c in cols), n, None, sort_by_score)
               for q in range(Q)]
        counts = torch.stack([r[0] for r in res])
        rows = torch.stack([r[1][:fetch_rows] for r in res])
    else:
        counts, rows = _select_sorted(*cols, n, None, sort_by_score)
        rows = rows[:, :fetch_rows]
    header = torch.stack([counts, torch.zeros_like(counts)], dim=1)
    return torch.cat([header[:, None, :], rows], dim=1)


def fused_match_sorted(buckets, patterns, *, n, pattern_statics,
                       sort_by_score=True, use_kernel=False, bits8=None):
    """One-call corpus match of one query: (1 + rows, 2) int32 on the
    corpus device. Row 0 is [match_count, 0]; rows 1.. are [index, meta]
    with meta = score<<16 | exact<<15 | greedy<<14 | end_col, matches
    first in (score desc, index asc) order when ``sort_by_score``, else
    index asc. ``patterns`` holds one (orig (n,), flip (n,), sc (9,))
    per pattern; ``bits8`` (per bucket presence planes) gives the kernel
    route its stage-1 reject."""
    GENERIC_ROUTES["kernel_body" if use_kernel else "pipeline_body"] += 1
    stacked = tuple(tuple(a[None] for a in p) for p in patterns)
    total = sum(b.size for b in buckets)
    return _fused_match_body(
        bits8, buckets, stacked, n=n, pattern_statics=pattern_statics,
        sort_by_score=sort_by_score, use_kernel=use_kernel,
        fetch_rows=total)[0]


def _fused_literal_batch_fast(buckets, pattern, *, n, statics, fetch_rows):
    """Q-batched single literal needles the column-stream literal kernel
    does not hold (over 16 units): the needle-value-independent context
    (:func:`literal.literal_context` over context derived from the
    kernels' rows) once per bucket, the per-query match, keys in the
    single flow's layout (``kernels.pack_keys``) and one sort over (Q,
    total) int64 keys, or one a query past ``SORT_BODY_BUDGET``."""
    _typos, _nopre, _neg, scoring, mode, nbl = statics
    orig_q, flip_q, _sc = pattern
    Q, nlen = orig_q.shape
    dev = orig_q.device
    idx_bits = max((n - 1).bit_length(), 1)
    idx_mask = (1 << idx_bits) - 1
    GENERIC_ROUTES["literal_fast"] += 1
    if not buckets or nlen == 0:
        return torch.zeros((Q, 1 + fetch_rows, 2), dtype=torch.int32,
                           device=dev)
    prep = []
    for b in buckets:
        cp_k, nu, idx = b.device_arrays_rowmajor()
        B, W = cp_k.shape
        if nlen > W:
            prep.append((None, B, idx))
            continue
        if b.unicode:
            cp, first, prev, boff, _blen, n_bytes = units_planes(cp_k, nu)
        else:
            cp, first, prev, boff, n_bytes = ascii_planes(cp_k, nu)
        ctx = literal_context(first, prev, boff, nu, n=nlen, W=W,
                              scoring=scoring)
        prep.append(((ctx, cp, nu, n_bytes, boff), B, idx))
    total = sum(p[1] for p in prep)
    sort_in_body = Q * total * 2 > SORT_BODY_BUDGET
    keys = []
    for q in range(Q):
        kq = []
        for args, B, idx in prep:
            if args is None:  # needle longer than the bucket width
                kq.append(torch.full((B,), INT64_MAX, dtype=torch.int64,
                                     device=dev))
                continue
            ctx, cp, nu, n_bytes, boff = args
            m, sc, e, ec = literal_match_ctx(
                ctx, cp, nu, n_bytes, boff, orig_q[q], flip_q[q], mode=mode,
                needle_byte_len=nbl, scoring=scoring)
            kq.append(pack_keys(m, sc, e, ec, torch.zeros_like(m), idx,
                                idx_bits))
        kq = torch.cat(kq)
        if sort_in_body:
            kq = torch.sort(kq).values[:fetch_rows]
        keys.append(kq)
    keys = torch.stack(keys)
    counts = (keys != INT64_MAX).sum(dim=1, dtype=torch.int32)
    if not sort_in_body:
        keys = torch.sort(keys, dim=1).values
    kc = keys[:, :fetch_rows]
    index, metas = _decode_keys(kc, idx_bits, idx_mask)
    rows = torch.stack([index, metas], dim=2)
    if rows.shape[1] < fetch_rows:
        rows = torch.cat([rows, torch.zeros(
            (Q, fetch_rows - rows.shape[1], 2), dtype=torch.int32,
            device=dev)], dim=1)
    header = torch.stack([counts, torch.zeros_like(counts)], dim=1)
    return torch.cat([header[:, None, :], rows], dim=1)


def fused_match_sorted_batch(
    bits8,  # per bucket PackedBucket.device_presence_bits()
    stacked_patterns,  # one (orig (Q,n), flip (Q,n), sc (Q,9)) per pattern
    *,
    n: int,  # corpus rows (sets the key's index width)
    pattern_statics: Tuple,  # per pattern (typos, no_prefilter, negated,
    #                          scoring, mode, nbl)
    fetch_rows: int,
    buckets,  # the corpus's PackedBuckets
    finalize_cap=None,  # host-chosen (cap_blocks, n_sel), or None
    sort_by_score: bool = True,
    use_kernel: bool = True,  # every bucket width and atom fits the kernels
):
    """Serve Q shape-uniform queries against one resident corpus: (Q, 1 +
    fetch_rows, 2) int32 on the corpus device (fewer rows on the generic
    routes when the buckets hold fewer than ``fetch_rows``, as the
    reference's scan slices them).

    Routes, decided as the reference's ``fused_match_sorted_batch``
    decides them. With ``use_kernel`` and a score sort: one non-negated
    fuzzy pattern takes :func:`_fused_match_batch_fast` (colstream or
    row-major flow, :func:`uses_colstream`), as does one non-negated
    literal needle of up to 16 units (colstream flow); several patterns,
    or one negated, whose atoms all pass :func:`colstream_eligible_all`
    take :func:`_fused_multi_batch_fast`; a single literal needle over
    16 units takes :func:`_fused_literal_batch_fast`. Everything else —
    index sorts, atoms beyond the column-stream budgets, and
    ``use_kernel=False`` (needles over 64 units, budgets over 8, widths
    the kernels do not hold) — takes the generic body
    (:func:`_fused_match_body`). ``finalize_cap`` applies to the
    colstream flows only."""
    mode0 = pattern_statics[0][4] if pattern_statics else None
    nlen0 = stacked_patterns[0][0].shape[1] if stacked_patterns else 0
    single = (use_kernel and sort_by_score and len(pattern_statics) == 1
              and not pattern_statics[0][2])
    if single and (mode0 == FUZZY_MODE
                   or colstream_literal_supported(nlen0)):
        return _fused_match_batch_fast(
            bits8, buckets, stacked_patterns[0], n=n,
            statics=pattern_statics[0], fetch_rows=fetch_rows,
            finalize_cap=finalize_cap,
        )
    if use_kernel and sort_by_score and colstream_eligible_all(
        pattern_statics, tuple(p[0].shape[1] for p in stacked_patterns)
    ):
        return _fused_multi_batch_fast(
            bits8, buckets, stacked_patterns, n=n,
            pattern_statics=pattern_statics, fetch_rows=fetch_rows,
            finalize_cap=finalize_cap,
        )
    if single:
        return _fused_literal_batch_fast(
            buckets, stacked_patterns[0], n=n, statics=pattern_statics[0],
            fetch_rows=fetch_rows,
        )
    GENERIC_ROUTES["kernel_body" if use_kernel else "pipeline_body"] += 1
    return _fused_match_body(
        bits8, buckets, stacked_patterns, n=n,
        pattern_statics=pattern_statics, sort_by_score=sort_by_score,
        use_kernel=use_kernel, fetch_rows=fetch_rows,
    )
