"""Fuzzy matching of one atom over a block of rows, vectorised over rows.

Semantics (saghen/frizbee: src/prefilter/mod.rs, src/matcher/algo.rs,
src/smith_waterman/algo/ascii.rs and unicode.rs):

1. Prefilter. With a typo budget T, a row matches when the needle, less
   at most T of its units, is an ordered subsequence of the row's units
   (each unit equal to the needle unit or its case flip); a needle no
   longer than T matches every row. Rows with fewer bytes than the
   needle has characters less T are rejected. Without a budget
   (``max_typos=None``) every row matches and is scored whole.
2. Window. T=0: from the first unit of the leftmost embedding to the
   last occurrence of the final needle unit at or after the embedding's
   end. T>0: from the first occurrence of any of the first T+1 needle
   units to the last occurrence of any of the last T+1 (the row's start
   or end where none occurs). The window then starts one byte earlier;
   on the unicode path a start inside a scalar skips its continuation
   bytes, keeping the last one as the first unit's bonus context. A
   window's first unit otherwise has no context.
3. Smith-Waterman over the window's units, u16 saturating: per needle
   row i and unit j,
   diag = H[i-1][j-1] (+ match + bonus[j] on a hit) - mismatch, then
   + matching-case bonus where the unit equals the needle as written;
   up = H[i-1][j] - gap_extend - (gap_open - gap_extend if unit j hit
   needle row i-1); left = H[i][j-1] - gap_extend - (gap_open -
   gap_extend if unit j-1 hit needle row i); H = max(diag, up, left).
   bonus[j]: capitalization where the unit's first byte is uppercase and
   the previous unit's last byte lowercase; delimiter where the previous
   last byte is an ASCII non-alphanumeric and the first byte is not;
   prefix at the window's first unit when the window starts the row.
   The score is the final row's maximum; end_col the byte offset of the
   first unit holding it (the window's start byte for a score of 0).
4. A window that is the whole row and equals the needle byte for byte
   adds the exact-match bonus and sets ``exact``.

A window of more than ``MAX_WINDOW_BYTES`` bytes (counted in bytes on
either unit mode) skips step 3: saghen/frizbee's greedy matcher scores it
(``greedy.py``), and step 4 applies as above.

The up moves of one column form a max-plus scan down the needle rows,
computed here with a cumulative maximum: H_i = max_k<=i (A_k - sum of the
up costs k+1..i), A = max(diag, left).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .greedy import greedy_scan
from .query import Atom
from .units import U16_MAX, Block, is_delim, is_lower, is_upper

# the DP's cap (saghen/frizbee: MAX_HAYSTACK_LEN,
# src/smith_waterman/algo/mod.rs:18): longer windows take the greedy
# matcher
MAX_WINDOW_BYTES = 1024


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Column of each row's first True (0 where none)."""
    return mask.to(torch.uint8).argmax(dim=1)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Column of each row's last True (L - 1 where none)."""
    return mask.shape[1] - 1 - _first_true(mask.flip(1))


def _prefilter(blk: Block, atom: Atom, T: int):
    """(matched, start unit or -1, end unit) of each row: the prefilter
    and its window's first and last match units (-1 start: the row's
    first unit, no occurrence)."""
    cp = blk.cp
    R, L = cp.shape
    dev = cp.device
    col = torch.arange(L, device=dev)[None, :]
    n = len(atom.orig)

    def hits(k):
        return (cp == atom.orig[k]) | (cp == atom.flip[k])

    last_unit = blk.n_units - 1
    if T == 0:
        ok = blk.n_units > 0
        pos = torch.full((R,), -1, dtype=torch.long, device=dev)
        start = pos
        for k in range(n):
            cand = hits(k) & (col > pos[:, None])
            ok = ok & cand.any(dim=1)
            pos = _first_true(cand)
            if k == 0:
                start = pos
        end = _last_true(hits(n - 1) & (col >= pos[:, None]))
        return ok, start, end
    if n <= T:
        everyone = torch.ones(R, dtype=torch.bool, device=dev)
        return everyone, torch.full_like(last_unit, -1), last_unit
    inf = L + 1
    f = torch.zeros((R, T + 1), dtype=torch.long, device=dev)
    for k in range(n):
        h = hits(k)
        nf = torch.full_like(f, inf)
        for t in range(T + 1):
            cand = h & (col >= f[:, t:t + 1])
            nxt = torch.where(cand.any(dim=1), _first_true(cand) + 1, inf)
            nxt = torch.where(f[:, t] < inf, nxt, inf)
            if t > 0:
                nxt = torch.minimum(nxt, f[:, t - 1])
            nf[:, t] = nxt
        f = nf
    ok = (f[:, T] < inf) & (blk.n_units > 0)
    head = torch.zeros((R, L), dtype=torch.bool, device=dev)
    for k in range(min(T + 1, n)):
        h = hits(k)
        # the first occurrence of each of these units
        first = _first_true(h)
        head |= h.any(dim=1, keepdim=True) & (col == first[:, None])
    start = torch.where(head.any(dim=1), _first_true(head), -1)
    tail = torch.zeros((R, L), dtype=torch.bool, device=dev)
    for k in range(n - 1 - T, n):
        tail |= hits(k)
    end = torch.where(tail.any(dim=1), _last_true(tail), last_unit)
    return ok, start, end


def _gather(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return m.gather(1, idx.clamp(0, m.shape[1] - 1))


def fuzzy_window(blk: Block, atom: Atom, max_typos: Optional[int]):
    """The prefilter and the trimmed window of every row of ``blk``:
    (rows it keeps, and for them the window's first unit, its length in
    units, its first unit's bonus context, its start and end bytes)."""
    R = blk.cp.shape[0]
    dev = blk.cp.device
    if max_typos is None:
        ok = torch.ones(R, dtype=torch.bool, device=dev)
        start = torch.full((R,), -1, dtype=torch.long, device=dev)
        end = blk.n_units - 1
    else:
        ok, start, end = _prefilter(blk, atom, int(max_typos))
        ok &= blk.n_bytes >= len(atom.needle) - int(max_typos)
    rows = torch.nonzero(ok).flatten()
    sub = blk.select(rows)
    s, e = start[rows], end[rows].long()
    # the window starts a byte before its first match unit: a whole unit
    # of one byte, or the tail of a longer one (skipped, its last byte
    # kept as context)
    s0 = s.clamp(min=0)
    head_byte = torch.where(s >= 0, _gather(sub.byte_off, s0[:, None])[:, 0],
                            0)
    wstart_byte = (head_byte - 1).clamp(min=0)
    prev_len = _gather(sub.byte_len, (s0 - 1)[:, None])[:, 0]
    step_back = (s > 0) & (prev_len == 1)
    wf = torch.where(step_back, s0 - 1, s0)
    ctx0 = torch.where((s > 0) & ~step_back,
                       _gather(sub.prev_last, s0[:, None])[:, 0], -1)
    wlen = (e - wf + 1).clamp(min=0)
    wlen = torch.where(sub.n_units > 0, wlen, 0)
    end_byte = torch.where(
        sub.n_units > 0,
        _gather(sub.byte_off, e[:, None])[:, 0]
        + _gather(sub.byte_len, e[:, None])[:, 0], 0)
    return rows, sub, wf, wlen, ctx0, wstart_byte, end_byte


def greedy_windows(windows: Callable, rows: torch.Tensor,
                   wstart_byte: torch.Tensor, end_byte: torch.Tensor,
                   atom: Atom, sc):
    """The greedy matcher over the byte windows ``[wstart_byte,
    end_byte)`` of the corpus rows ``rows``; ``windows(rows, start,
    length)`` gives a padded matrix of their bytes."""
    wlen = end_byte - wstart_byte
    return greedy_scan(windows(rows, wstart_byte, wlen), wlen, atom, sc,
                       wstart_byte == 0)


def _smith_waterman(sub: Block, wf, wlen, ctx0, wstart_byte, atom: Atom,
                    sc):
    """(best score, its end_col) of each row of ``sub`` over its window
    of ``wlen`` units from unit ``wf`` (step 3)."""
    dev = sub.cp.device
    n = len(atom.orig)
    W = int(wlen.max())
    colw = torch.arange(max(W, 1), device=dev)[None, :]
    idx = wf[:, None] + colw
    valid = colw < wlen[:, None]
    cpw = torch.where(valid, _gather(sub.cp, idx), -1)
    fb = _gather(sub.first, idx)
    pb = _gather(sub.prev_last, idx)
    pb[:, 0] = ctx0
    bw = _gather(sub.byte_off, idx)
    include_prefix = wstart_byte == 0
    bonus = (sc["capitalization_bonus"] * (is_upper(fb) & is_lower(pb))
             + sc["delimiter_bonus"] * (is_delim(pb) & ~is_delim(fb)))
    bonus[:, 0] += sc["prefix_bonus"] * include_prefix
    bonus = bonus.to(torch.int32)

    # the DP state is needle-row-major, (n, rows): the scans run down
    # the outer dimension, one row of the corpus a thread
    o = torch.tensor(atom.orig, dtype=torch.int32, device=dev)[:, None]
    fl = torch.tensor(atom.flip, dtype=torch.int32, device=dev)[:, None]
    ms, mm = sc["match_score"], sc["mismatch_penalty"]
    ge = sc["gap_extend_penalty"]
    go = max(sc["gap_open_penalty"] - ge, 0)
    cb = sc["matching_case_bonus"]
    Rs = len(wf)
    cpT, bonusT, validT = (x.T.contiguous() for x in (cpw, bonus, valid))
    H = torch.zeros((n, Rs), dtype=torch.int32, device=dev)
    hit_prev = torch.zeros((n, Rs), dtype=torch.bool, device=dev)
    zero_row = torch.zeros((1, Rs), dtype=torch.int32, device=dev)
    best = torch.zeros(Rs, dtype=torch.int32, device=dev)
    best_col = torch.zeros(Rs, dtype=torch.long, device=dev)
    for c in range(W):
        u = cpT[c][None, :]
        ex = u == o
        hit = ex | (u == fl)
        Hd = torch.cat([zero_row, H[:-1]], dim=0)
        diag = torch.where(hit, Hd + (ms + mm) + bonusT[c][None, :], Hd)
        diag = (diag - mm).clamp(min=0) + cb * ex.int()
        left = (H - (ge + go * hit_prev.int())).clamp(min=0)
        A = torch.maximum(diag, left)
        up_cost = torch.cumsum(ge + go * hit[:-1].int(), dim=0,
                               dtype=torch.int32)
        P = torch.cat([zero_row, up_cost], dim=0)
        H = torch.cummax(A + P, dim=0).values - P
        hit_prev = hit
        h = H[-1]
        better = validT[c] & (h > best)
        best = torch.where(better, h, best)
        best_col = torch.where(better, c, best_col)
    ec = torch.where(best > 0, _gather(bw, best_col[:, None])[:, 0],
                     wstart_byte)
    return best, ec


def fuzzy_block(blk: Block, atom: Atom, max_typos: Optional[int], sc,
                windows: Callable):
    """(matched, score, exact, end_col) of every row of ``blk`` for one
    fuzzy atom; ``sc`` is the scoring dict, ``windows`` the corpus's
    byte windows (``Units.byte_windows``) for the greedy matcher."""
    R = blk.cp.shape[0]
    dev = blk.cp.device
    n = len(atom.orig)
    matched = torch.zeros(R, dtype=torch.bool, device=dev)
    score = torch.zeros(R, dtype=torch.int32, device=dev)
    exact = torch.zeros(R, dtype=torch.bool, device=dev)
    end_col = torch.zeros(R, dtype=torch.int32, device=dev)
    if n == 0 or R == 0:
        return matched, score, exact, end_col
    rows, sub, wf, wlen, ctx0, wstart_byte, end_byte = fuzzy_window(
        blk, atom, max_typos)
    matched[rows] = True
    if len(rows) == 0:
        return matched, score, exact, end_col
    best = torch.zeros(len(rows), dtype=torch.int32, device=dev)
    ec = torch.zeros(len(rows), dtype=torch.long, device=dev)
    over = (end_byte - wstart_byte) > MAX_WINDOW_BYTES
    dp = torch.nonzero(~over).flatten()
    if len(dp):
        dp_best, dp_ec = _smith_waterman(
            sub.select(dp), wf[dp], wlen[dp], ctx0[dp], wstart_byte[dp],
            atom, sc)
        best[dp], ec[dp] = dp_best, dp_ec.long()
    gr = torch.nonzero(over).flatten()
    if len(gr):
        ws = wstart_byte[gr]
        scan = greedy_windows(windows, sub.rows[gr], ws, end_byte[gr], atom,
                              sc)
        best[gr] = scan.score.int()
        ec[gr] = torch.where(scan.found, ws + scan.last, ws)
    include_exact = (wstart_byte == 0) & (end_byte == sub.n_bytes)
    same = (sub.n_units == n) & (sub.n_bytes == len(atom.needle_bytes))
    width = sub.cp.shape[1]
    o = torch.tensor(atom.orig, dtype=torch.int32, device=dev)[None, :]
    if n <= width:
        same &= (sub.cp[:, :n] == o).all(dim=1)
    else:
        same &= False
    ex_row = include_exact & same
    best = torch.where(ex_row, (best + sc["exact_match_bonus"]).clamp(
        max=U16_MAX), best)
    score[rows] = best.clamp(max=U16_MAX)
    exact[rows] = ex_row
    end_col[rows] = ec.clamp(max=U16_MAX).to(torch.int32)
    return matched, score, exact, end_col
