"""Literal matching of one atom over a block of rows, vectorised over rows
and start positions (saghen/frizbee: src/literal/algo.rs).

A literal atom matches a contiguous run of the row's bytes, unit by
unit: each needle unit's bytes equal the unit as written or its case
flip. Exact: the row is the run; prefix: the run starts the row; suffix:
it ends the row; substring: the highest-scoring start, the earliest on a
tie. The score sums, per needle unit, the match score, the matching-case
bonus where the bytes are the unit as written, and the prefix bonus at
byte 0 or else the capitalization and delimiter bonuses from the unit's
first byte and the byte before it; a run that is the whole row adds the
exact-match bonus. end_col is the run's last byte; ``exact`` marks a run
that is the whole row. The typo budget does not apply.
"""

from __future__ import annotations

import torch

from .query import EXACT, PREFIX, SUBSTRING, SUFFIX, Atom
from .units import U16_MAX, is_delim, is_lower, is_upper


def literal_block(byts: torch.Tensor, n_bytes: torch.Tensor, atom: Atom,
                  sc):
    """(matched, score, exact, end_col) of each row of the (R, L) byte
    matrix ``byts`` (padded with -1) for one literal atom."""
    R, L = byts.shape
    dev = byts.device
    nb = len(atom.needle_bytes)
    matched = torch.zeros(R, dtype=torch.bool, device=dev)
    score = torch.zeros(R, dtype=torch.int32, device=dev)
    exact = torch.zeros(R, dtype=torch.bool, device=dev)
    end_col = torch.zeros(R, dtype=torch.int32, device=dev)
    if nb == 0 or R == 0 or nb > L:
        return matched, score, exact, end_col
    P = L - nb + 1
    pos = torch.arange(P, device=dev)[None, :]
    ok = pos <= (n_bytes - nb)[:, None]
    total = torch.zeros((R, P), dtype=torch.int32, device=dev)

    def at(off):  # (R, P): byte at start + off
        return byts[:, off:off + P]

    off = 0
    for ob, fb in zip(atom.orig_bytes, atom.flip_bytes):
        is_o = torch.ones((R, P), dtype=torch.bool, device=dev)
        is_f = torch.ones((R, P), dtype=torch.bool, device=dev)
        for j in range(len(ob)):
            b = at(off + j)
            is_o &= b == ob[j]
            is_f &= b == fb[j]
        ok &= is_o | is_f
        first = at(off)
        if off == 0:
            prev = torch.cat([torch.full((R, 1), -1, dtype=byts.dtype,
                                         device=dev), byts[:, :P - 1]], 1)
        else:
            prev = at(off - 1)
        start0 = (pos + off) == 0
        bonus = torch.where(
            start0, sc["prefix_bonus"],
            sc["capitalization_bonus"] * (is_upper(first) & is_lower(prev))
            + sc["delimiter_bonus"] * (is_delim(prev) & ~is_delim(first)))
        total = total + (sc["match_score"]
                         + sc["matching_case_bonus"] * is_o.int()
                         + bonus).to(torch.int32)
        off += len(ob)
    whole = (pos == 0) & (n_bytes == nb)[:, None]
    total = torch.where(whole, total + sc["exact_match_bonus"], total)
    total = total.clamp(max=U16_MAX)
    mode = atom.mode
    if mode == SUBSTRING:
        cand = torch.where(ok, total, -1)
        best = cand.max(dim=1)
        m = best.values >= 0
        p = best.indices  # the first maximum: the earliest start
    else:
        if mode in (EXACT, PREFIX):
            p = torch.zeros(R, dtype=torch.long, device=dev)
        elif mode == SUFFIX:
            p = (n_bytes - nb).clamp(min=0).long()
        else:
            raise ValueError(f"not a literal mode: {mode}")
        m = ok.gather(1, p[:, None].clamp(max=P - 1))[:, 0] & (
            n_bytes >= nb)
        if mode == EXACT:
            m &= n_bytes == nb
    s = total.gather(1, p[:, None].clamp(max=P - 1))[:, 0]
    matched = m
    score = torch.where(m, s, 0)
    exact = m & (p == 0) & (n_bytes == nb)
    end_col = torch.where(m, (p + nb - 1).clamp(0, U16_MAX), 0).to(
        torch.int32)
    return matched, score, exact, end_col
