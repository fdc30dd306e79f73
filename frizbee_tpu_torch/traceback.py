"""Batched alignment traceback on the host: a native per-row fill and walk
over all matched rows, with its NumPy twin (a vectorized fill and a lockstep
walk).

Copy of ``frizbee_tpu/traceback.py``. ``Matcher.match_list_indices``
selects and orders the matches on the card (``match_arrays``); the
matched-byte indices come from an alignment traceback, which runs here, on
the host, as in the reference (its own walk is a native matrix walk per
match, reference: src/smith_waterman/alignment_iter.rs:112-181):

1. The matched haystacks pack into width buckets on the CPU (the same
   packer the device corpus uses, ``pack_corpus(..., device="cpu")``);
   each bucket's UTF-8 context comes from ``PackedBucket._full_arrays``.
2. Prefilter windows fill vectorized over all rows at once.
3. ``native.sw_indices_batch`` (``native/packer.cpp``, OpenMP over rows)
   fills each row's (n+1)-row score matrix over its window and walks it,
   emitting reversed matched byte offsets.

Under the test hook ``_FORCE_NUMPY`` step 3 is the NumPy twin: the score
matrices and match masks fill vectorized over all rows (each needle row
one NumPy pass whose left-gap propagation is the exact max-plus prefix
scan, np.maximum.accumulate, the recurrence the device kernels and the
scalar oracle implement, see oracle/smith_waterman.py), then the
traceback walks all rows in lockstep, one (R,) gather per step. That fill
and walk run on at most ``FILL_CELLS`` matrix cells at a time (rows of
one bucket in chunks), which bounds the host memory of a large match set
and leaves every row's result unchanged.

Greedy windows (over MAX_HAYSTACK_LEN bytes) and XL rows take the engine's
native batch with traceback (``engine.match_many_indices``); under
``_FORCE_NUMPY`` they stay None and the caller serves them through the
per-row oracle (``Matcher.match_one_indices``).

int32 accumulators stand in for the reference's u16 saturating arithmetic:
configs that pass the overflow guard never saturate above, and chained
saturating subtractions below equal a single clamp at zero.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import native
from .config import MAX_HAYSTACK_LEN, Scoring
from .corpus import DEFAULT_BUCKETS, pack_corpus

# Test hook, as in frizbee_tpu: the NumPy fill and walk in place of
# native.sw_indices_batch, and no tail call to engine.match_many_indices.
_FORCE_NUMPY = False

# Matrix cells (rows x (n+1) x (W+1)) of one NumPy fill and walk: bounds
# the (H, MM) pair at 5 bytes a cell
FILL_CELLS = 1 << 25


def _unit_occ(cp: np.ndarray, valid: np.ndarray, orig: int, flip: int
              ) -> np.ndarray:
    return valid & ((cp == orig) | (cp == flip))


def prefilter_windows(
    cp: np.ndarray,  # (B, W) int32 unit values
    byte_off: np.ndarray,
    byte_len: np.ndarray,
    n_units: np.ndarray,  # (B,)
    n_bytes: np.ndarray,  # (B,)
    orig: np.ndarray,  # (n,) int32
    flip: np.ndarray,
    max_typos: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized minimal-position prefilter DP; NumPy twin of
    ops/fuzzy.prefilter_bucket (semantics contract: oracle/prefilter.py).
    Returns (matched, wstart_byte, wend_byte), untrimmed."""
    B, W = cp.shape
    n = len(orig)
    T = int(max_typos)
    BIG = W + 1
    nb = n_bytes.astype(np.int32)
    if n <= T:
        return np.ones(B, bool), np.zeros(B, np.int32), nb

    cols = np.arange(W, dtype=np.int32)[None, :]
    valid = cols < n_units[:, None]

    def first_at_or_after(occ, pos):
        return np.min(np.where(occ & (cols >= pos[:, None]), cols, BIG),
                      axis=1)

    f = [np.zeros(B, np.int32) for _ in range(T + 1)]
    first_occ_start = np.full(B, BIG, np.int32)
    start_zero = np.zeros(B, np.int32)
    occ_tail = np.zeros((B, W), bool)
    occ_last = None
    for k in range(n):
        occ = _unit_occ(cp, valid, int(orig[k]), int(flip[k]))
        if k == n - 1:
            occ_last = occ
        if k >= n - 1 - T:
            occ_tail |= occ
        if k <= T:
            first_occ_start = np.minimum(
                first_occ_start, np.min(np.where(occ, cols, BIG), axis=1)
            )
        nf = []
        for t in range(T + 1):
            nxt = np.where(
                f[t] <= W,
                np.minimum(first_at_or_after(occ, f[t]) + 1, BIG),
                BIG,
            )
            if t > 0:
                nxt = np.minimum(nxt, f[t - 1])
            nf.append(nxt)
        if k == 0:
            start_zero = np.minimum(nf[0] - 1, W)
        f = nf
    matched = f[T] <= W

    def gather(x, idx):
        return np.take_along_axis(x, idx[:, None], axis=1)[:, 0]

    if T == 0:
        last_pos = f[0] - 1
        e = np.max(
            np.where(occ_last & (cols >= last_pos[:, None]), cols, -1),
            axis=1,
        )
        start_u = np.clip(start_zero, 0, W - 1)
        wstart = gather(byte_off, start_u)
    else:
        e = np.max(np.where(occ_tail, cols, -1), axis=1)
        start_u = np.clip(first_occ_start, 0, W - 1)
        wstart = np.where(
            first_occ_start <= W, gather(byte_off, start_u), 0
        )
    e_c = np.clip(e, 0, W - 1)
    wend = gather(byte_off, e_c) + gather(byte_len, e_c)
    wend = np.where(e >= 0, wend, nb)
    wstart = np.where(matched, wstart, 0)
    wend = np.where(matched, wend, nb)
    return matched, wstart.astype(np.int32), wend.astype(np.int32)


def sw_fill(
    cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
    wstart, wend,  # trimmed window, byte coords, (B,)
    orig, flip, scoring: Scoring,
) -> Tuple[np.ndarray, np.ndarray]:
    """(H (B, n+1, W+1) int32, MM (B, n+1, W+1) bool) score/match-mask
    matrices, window-masked. Column 0 is the virtual empty column; lanes
    outside the window hold zeros (equivalent to the oracle's window
    slicing — see the masking argument in ops/kernels._match_tile)."""
    B, W = cp.shape
    n = len(orig)
    ms = scoring.match_score
    mm_pen = scoring.mismatch_penalty
    gap_ext = scoring.gap_extend_penalty
    gop_extra = max(scoring.gap_open_penalty - gap_ext, 0)

    cols = np.arange(W, dtype=np.int32)[None, :]
    valid = cols < n_units[:, None]
    active = (
        valid
        & (byte_off >= wstart[:, None])
        & (byte_off + byte_len <= wend[:, None])
    )
    first_unit = np.min(np.where(active, cols, W + 1), axis=1)
    is_first = active & (cols == first_unit[:, None])
    include_prefix = (wstart == 0)[:, None]

    fb, pb = first_byte, prev_last_byte
    is_upper = (fb >= 0x41) & (fb <= 0x5A)
    prev_lower = (pb >= 0x61) & (pb <= 0x7A)

    def delim(b):
        letter = ((b >= 0x41) & (b <= 0x5A)) | ((b >= 0x61) & (b <= 0x7A))
        digit = (b >= 0x30) & (b <= 0x39)
        return (b >= 0) & (b <= 127) & ~letter & ~digit

    bonus = (
        np.where(is_upper & prev_lower & ~is_first,
                 scoring.capitalization_bonus, 0)
        + np.where(delim(pb) & ~delim(fb) & ~is_first,
                   scoring.delimiter_bonus, 0)
        + np.where(is_first & include_prefix, scoring.prefix_bonus, 0)
    ).astype(np.int32)

    H = np.zeros((B, n + 1, W + 1), np.int32)
    MM = np.zeros((B, n + 1, W + 1), bool)
    prev_row = H[:, 0, 1:]
    prev_mm = MM[:, 0, 1:]
    for i in range(1, n + 1):
        match = active & _unit_occ(cp, valid, int(orig[i - 1]),
                                   int(flip[i - 1]))
        exactc = active & (cp == int(orig[i - 1]))
        diag_base = np.concatenate(
            [np.zeros((B, 1), np.int32), prev_row[:, :-1]], axis=1
        )
        diag = np.where(
            match,
            diag_base + ms + bonus
            + np.where(exactc, scoring.matching_case_bonus, 0),
            np.maximum(diag_base - mm_pen, 0),
        )
        up = np.maximum(
            prev_row - gap_ext - np.where(prev_mm, gop_extra, 0), 0
        )
        c = np.maximum(diag, up)
        p = gap_ext + np.where(match, gop_extra, 0)
        q = np.concatenate(
            [np.zeros((B, 1), np.int32), np.cumsum(p, axis=1)[:, :-1]],
            axis=1,
        )
        row = np.maximum.accumulate(c + q, axis=1) - q
        row = np.where(active, row, 0)
        H[:, i, 1:] = row
        MM[:, i, 1:] = match
        prev_row = row
        prev_mm = match
    return H, MM


def walk_indices(
    H: np.ndarray,  # (B, n+1, W+1) int32
    MM: np.ndarray,
    byte_off: np.ndarray,  # (B, W)
    byte_len: np.ndarray,
    max_typos: Optional[int],
) -> Tuple[np.ndarray, List[List[int]]]:
    """Lockstep traceback over all rows. Returns (score (B,), per-row
    reversed matched byte offsets). Semantics contract:
    oracle/smith_waterman.sw_indices (typo budget truncates indices but
    keeps the score; zero scores yield no indices)."""
    B, n1, W1 = H.shape
    n = n1 - 1
    final = H[:, n, 1:]
    score = final.max(axis=1, initial=0)
    # start column: first final-row column holding the score (1-based)
    col = np.argmax(final == score[:, None], axis=1).astype(np.int32) + 1
    row = np.full(B, n, np.int32)
    cur = score.copy()
    typo = np.zeros(B, np.int32)
    alive = score > 0
    row[~alive] = 0

    emits_step: List[np.ndarray] = []  # per step: (rows_emitting, unit)
    flat = np.arange(B, dtype=np.int32)

    def hval(r, c):
        return H[flat, np.maximum(r, 0), np.maximum(c, 0)]

    budget = None if max_typos is None else int(max_typos)
    for _step in range(n + W1 + 1):
        if not alive.any():
            break
        if budget is not None:
            alive &= ~(typo > budget)
        alive &= (col >= 1) & (cur > 0) & (row > 0)
        if not alive.any():
            break
        is_m = MM[flat, row, col] & alive
        # matched step: emit unit, move diagonally
        if is_m.any():
            emits_step.append(
                np.stack([np.nonzero(is_m)[0], col[is_m] - 1])
            )
        nrow = np.where(is_m, row - 1, row)
        ncol = np.where(is_m, col - 1, col)
        ncur = np.where(is_m, hval(row - 1, col - 1), cur)
        # unmatched step: argmax of (diag, left, up) with diag/left priority
        diag = hval(row - 1, col - 1)
        left = hval(row, col - 1)
        up = hval(row - 1, col)
        take_diag = (diag >= left) & (diag >= up)
        take_left = ~take_diag & (left >= up)
        u_row = np.where(take_diag | ~take_left, row - 1, row)
        u_col = np.where(take_diag | take_left, col - 1, col)
        u_cur = np.where(take_diag, diag, np.where(take_left, left, up))
        u_typo = typo + np.where(take_diag | ~take_left, 1, 0)

        sel_u = alive & ~is_m
        row = np.where(sel_u, u_row, nrow)
        col = np.where(sel_u, u_col, ncol)
        cur = np.where(sel_u, u_cur, ncur)
        typo = np.where(sel_u, u_typo, typo)

    # assemble per-row reversed byte indices from the emit log
    out: List[List[int]] = [[] for _ in range(B)]
    for emit in emits_step:
        rows_e, units_e = emit
        offs = byte_off[rows_e, units_e]
        lens = byte_len[rows_e, units_e]
        for r, o, ln in zip(rows_e, offs, lens):
            out[int(r)].extend(range(int(o) + int(ln) - 1, int(o) - 1, -1))
    return score, out


def batched_match_indices(engine, haystacks: List[str]) -> List[Optional[tuple]]:
    """(score, exact, reversed byte indices) per haystack via the batched
    fill and walk. None marks a row that does not match (callers pass
    device-selected matches, so that only happens for size-gated rows),
    and under ``_FORCE_NUMPY`` the greedy and XL rows too: the caller
    serves those through the per-row oracle."""
    cfg = engine.config
    scoring = cfg.scoring
    results: List[Optional[tuple]] = [None] * len(haystacks)
    if not haystacks or not engine.units.orig:
        return results
    # host code: the repack never goes to the card
    corpus = pack_corpus(haystacks, engine.unicode,
                         bucket_widths=DEFAULT_BUCKETS, device="cpu")
    orig, flip, scoring9 = engine._host_needle()
    needle_bytes = engine.needle_bytes

    for bucket in corpus.buckets:
        real = bucket.indices >= 0
        cp, fbyte, pbyte, boff, blen = bucket._full_arrays()
        nu = bucket.n_units.astype(np.int32)
        nb = bucket.n_bytes.astype(np.int32)
        if cfg.max_typos is None:
            matched = np.ones(len(nu), bool)
            ws_raw = np.zeros(len(nu), np.int32)
            we = nb
        else:
            matched, ws_raw, we = prefilter_windows(
                cp, boff, blen, nu, nb, orig, flip, cfg.max_typos
            )
        wstart = np.maximum(ws_raw - 1, 0)
        small = (we - wstart) <= MAX_HAYSTACK_LEN
        # compact to the rows being walked (callers pass matches, but the
        # bucket also carries size-class padding and gated rows); the
        # NumPy twin takes them a chunk of at most FILL_CELLS matrix
        # cells at a time
        todo_all = np.nonzero(matched & real & small)[0]
        step = max(todo_all.size, 1)
        if _FORCE_NUMPY:
            step = max(1, FILL_CELLS // ((len(orig) + 1)
                                         * (bucket.width + 1)))
        for s in range(0, todo_all.size, step):
            todo = todo_all[s : s + step]
            cp_c, fb_c, pb_c = cp[todo], fbyte[todo], pbyte[todo]
            bo_c, bl_c = boff[todo], blen[todo]
            ws_c, we_c, nu_c = wstart[todo], we[todo], nu[todo]
            if _FORCE_NUMPY:
                H, MM = sw_fill(
                    cp_c, fb_c, pb_c, bo_c, bl_c, nu_c, ws_c, we_c, orig,
                    flip, scoring,
                )
                score, idx_lists = walk_indices(
                    H, MM, bo_c, bl_c, cfg.max_typos
                )
                del H, MM
            else:
                # the window in unit columns: the units wholly inside the
                # trimmed byte window
                cols = np.arange(cp_c.shape[1], dtype=np.int32)[None, :]
                act = (
                    (cols < nu_c[:, None])
                    & (bo_c >= ws_c[:, None])
                    & (bo_c + bl_c <= we_c[:, None])
                )
                m_units = act.sum(axis=1).astype(np.int32)
                su = np.where(
                    m_units > 0, np.argmax(act, axis=1), 0
                ).astype(np.int32)
                score, cnt, idx = native.sw_indices_batch(
                    cp_c, fb_c, pb_c, bo_c, bl_c, su, su + m_units,
                    ws_c == 0, orig, flip, scoring9, cfg.max_typos,
                )
                idx_lists = [idx[r, : cnt[r]].tolist()
                             for r in range(len(todo))]
            # the full-string equality check only runs when the byte
            # length already matches the needle's (the common case skips
            # encode())
            include_exact = (
                (ws_c == 0)
                & (we_c == nb[todo])
                & (nb[todo] == len(needle_bytes))
            )
            for r, br in enumerate(todo):
                gi = int(bucket.indices[br])
                sc = int(score[r])
                exact = bool(include_exact[r]) and (
                    haystacks[gi].encode("utf-8") == needle_bytes
                )
                if exact:
                    sc = min(sc + scoring.exact_match_bonus, 0xFFFF)
                inds = idx_lists[r] if sc > 0 else []
                results[gi] = (sc, exact, inds)

    # Long rows the bucket walk can't cover (greedy windows beyond the DP
    # cap, XL rows beyond the widest bucket) go to the engine's native
    # batch with traceback; under _FORCE_NUMPY they stay None and fall back
    # to the per-row match_one_indices oracle in the caller.
    if not _FORCE_NUMPY:
        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            nat = engine.match_many_indices(
                [haystacks[i] for i in missing]
            )
            if nat is not None:
                for i, r in zip(missing, nat):
                    if r is not None:
                        results[i] = r
    return results
