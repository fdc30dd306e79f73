"""saghen/frizbee's greedy matcher (src/smith_waterman/greedy.rs:7-91),
which scores the windows longer than the DP's cap, vectorised over rows.

The scan walks the window's bytes on either unit mode (a non-ASCII
needle is matched byte by byte, its case flip ASCII only). Per needle
byte in order:

1. The hit is the first byte at or after the scan position that equals
   the needle byte as written or its case flip, and no later than
   ``len(window) - len(needle) + the needle byte's index``. A needle
   byte with no hit leaves the row matched with score 0, not exact, its
   end column at the window's start byte.
2. A hit adds the match score; a hit of any needle byte but the first
   after a skipped run of ``r`` bytes then subtracts ``gap_open +
   gap_extend * (r - 1)``.
3. It then adds the matching-case bonus where the byte is the needle
   byte as written; the capitalization bonus on an uppercase byte after a
   lowercase one; the prefix bonus at the window's first byte where the
   window starts the row; the delimiter bonus on a non-delimiter byte
   after a delimiter, but only once the scan has passed a non-delimiter
   byte (the greedy path's own rule, which the DP does not share). The
   scan's state starts fresh at the window's first byte.

All arithmetic saturates at 0 and 0xFFFF. The scan stops at the last
needle byte's hit: the bytes it read are the window's up to that hit, or
up to the failing needle byte's last place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .query import Atom, _flip_byte
from .units import U16_MAX, is_delim, is_lower, is_upper


@dataclass
class Scan:
    """Per row: whether every needle byte was placed, the score, the
    offset of the last hit in the window, and the bytes the scan read."""

    found: torch.Tensor
    score: torch.Tensor
    last: torch.Tensor
    scanned: torch.Tensor


def greedy_scan(win: torch.Tensor, wlen: torch.Tensor, atom: Atom, sc,
                include_prefix: torch.Tensor) -> Scan:
    """The greedy matcher over each row of the (R, W) window byte matrix
    ``win`` (padded with -1 past each row's ``wlen`` bytes);
    ``include_prefix`` marks the windows that start their row."""
    R, W = win.shape
    dev = win.device
    orig = list(atom.needle_bytes)
    flip = orig if atom.case_sensitive else [_flip_byte(c) for c in orig]
    nb = len(orig)
    col = torch.arange(W, device=dev)[None, :]
    upper, lower, delim = is_upper(win), is_lower(win), is_delim(win)
    # the scan's state on reaching each byte: the byte before it
    # lowercase; the byte before it a delimiter after some non-delimiter
    none = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    seen = torch.cumsum((~delim).int(), dim=1, dtype=torch.int32) > 0
    prev_lower = torch.cat([none, lower[:, :-1]], dim=1)
    prev_delim = torch.cat([none, (delim & seen)[:, :-1]], dim=1)
    bonus = (sc["capitalization_bonus"] * (upper & prev_lower).int()
             + sc["delimiter_bonus"] * (prev_delim & ~delim).int())
    bonus[:, 0] += sc["prefix_bonus"] * include_prefix.int()

    ge, go = sc["gap_extend_penalty"], sc["gap_open_penalty"]
    found = torch.ones(R, dtype=torch.bool, device=dev)
    score = torch.zeros(R, dtype=torch.long, device=dev)
    last = torch.zeros(R, dtype=torch.long, device=dev)
    pos = torch.zeros(R, dtype=torch.long, device=dev)
    scanned = torch.zeros(R, dtype=torch.long, device=dev)
    for k in range(nb):
        limit = wlen.long() - nb + k
        cand = (((win == orig[k]) | (win == flip[k]))
                & (col >= pos[:, None]) & (col <= limit[:, None]))
        hit = cand.any(dim=1)
        j = cand.to(torch.uint8).argmax(dim=1)
        # a row that fails here read every byte up to this byte's limit
        scanned = torch.where(found & ~hit,
                              torch.maximum(pos, limit + 1), scanned)
        found &= hit
        s = (score + sc["match_score"]).clamp(max=U16_MAX)
        if k > 0:
            run = j - pos
            pen = (go + (ge * (run - 1).clamp(0, U16_MAX)).clamp(
                max=U16_MAX)).clamp(max=U16_MAX)
            s = torch.where(run > 0, (s - pen).clamp(min=0), s)
        at = win.gather(1, j[:, None])[:, 0]
        s = (s + bonus.gather(1, j[:, None])[:, 0]
             + sc["matching_case_bonus"] * (at == orig[k]).long()).clamp(
                 max=U16_MAX)
        score = torch.where(found, s, score)
        last = torch.where(found, j, last)
        pos = torch.where(found, j + 1, pos)
    scanned = torch.where(found, last + 1, scanned)
    return Scan(found, torch.where(found, score, 0), last, scanned)
