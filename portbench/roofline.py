"""The least time of a batch's matching work on one H100, counted from the
cell's corpus and queries alone (never from the program's launches).

Peaks and operation counts are ``chip_smoke.py``'s, frozen here: bytes
at the H100 SXM's 3.35e12 B/s, int32 operations at the card's issue rate
(4 schedulers x 32 lanes an SM a clock x 132 SMs x 1.98 GHz). The
operations a unit of work takes are the port's kernel designs' counts
(chip_smoke's comments give each instruction).

The work of one query is the sum over its atoms:

- alive rows: rows whose units hold the atom's needle units (with their
  multiplicity, case-folded; with a typo budget T, all but T of them), a
  row-level presence filter; with no budget every row;
- a fuzzy atom walks each alive row's units through the prefilter (a
  per-column cost by prefilter kind), then runs the Smith-Waterman DP
  over the trimmed window of each row the prefilter keeps, n cells a
  unit (the reference's own prefilter and window decide both); a window
  of more than 1,024 bytes takes saghen/frizbee's greedy scan instead,
  ``GREEDY_OPS_PER_BYTE`` a byte the scan reads (the reference's own scan
  says how far it reads);
- a literal atom walks each alive row's columns (only the first n for
  exact and prefix), n cells a column and a per-column cost.

Bytes: every unit of a row alive for some query of the batch, once (1
byte a byte unit, 4 a codepoint), and 8 bytes a row so read (its index
and unit count); a greedy scan reads the window's UTF-8 bytes, which in
byte units are the units already counted and in codepoint units are
another array: there each row adds its longest greedy window of the
batch once (no fewer bytes than any scan of it reads). Written: a (1 +
k)-row answer of 8-byte entries a query. The bound is the larger of the
bytes' time and the operations'.

The work is counted the same whatever scores it, the card or the host.
Each batch also gives the part past the DP's cap: the work and bytes of
rows over 1,024 codepoints (wider than the widest bucket, so the port
scores them on the host) and the greedy windows' scans and bytes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.fuzzy import (MAX_WINDOW_BYTES, fuzzy_window,
                                       greedy_windows)
from portbench.reference.query import EXACT, FUZZY, PREFIX, parse_query
from portbench.reference.serve import BLOCK_CELLS, DEFAULT_SCORING, Corpus

# H100 SXM peaks (chip_smoke.py)
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 128 * 132 * 1.98e9
# int32 operations a cell or a column (chip_smoke.py)
GREEDY_LOOKUP_FROM = 4
PF_GREEDY_OPS_PER_COLUMN = 20
PF_GREEDY_OPS_PER_CELL_SHORT = 6
PF_GREEDY_OPS_PER_COLUMN_SHORT = 8
PF_DP_OPS_PER_CELL = 5
PF_DP_OPS_PER_STATE = 3
SW_OPS_PER_CELL = 10
LIT_OPS_PER_CELL = 7
LIT_OPS_PER_COLUMN = 8
# the greedy scan a window byte it reads (saghen/frizbee
# src/smith_waterman/greedy.rs:40-60): load the byte (1); its digit,
# upper and lower tests, a subtract and a compare each (6); the
# delimiter test, at most 127 and none of the three (3); the flag that a
# non-delimiter was seen (1); the compares with the needle byte and its
# case flip and their or (3); the delimiter state (1); the position's
# increment and its limit compare (2)
GREEDY_OPS_PER_BYTE = 17
# the widest bucket: longer rows are scored on the host (XL rows)
XL_UNITS = 1024


def _bound(in_bytes, out_bytes, ops):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and int32 operations over the issue rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / ISSUE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def prefilter_ops_per_column(n: int, max_typos) -> int:
    if max_typos is None:
        return 0
    T = min(int(max_typos), n)
    if T == 0:
        if n >= GREEDY_LOOKUP_FROM:
            return PF_GREEDY_OPS_PER_COLUMN
        return n * PF_GREEDY_OPS_PER_CELL_SHORT + PF_GREEDY_OPS_PER_COLUMN_SHORT
    return n * (PF_DP_OPS_PER_CELL + PF_DP_OPS_PER_STATE * (T + 1))


def _alive(values: torch.Tensor, atom, max_typos, literal: bool):
    """Rows of an (R, L) unit matrix that hold the atom's needle units."""
    R = values.shape[0]
    if max_typos is None and not literal:
        return torch.ones(R, dtype=torch.bool, device=values.device)
    need: Dict[tuple, int] = {}
    if literal:
        pairs = [(ob[0], fb[0]) for ob, fb in zip(atom.orig_bytes,
                                                  atom.flip_bytes)]
    else:
        pairs = list(zip(atom.orig, atom.flip))
    for o, f in pairs:
        key = (min(o, f), max(o, f))
        need[key] = need.get(key, 0) + 1
    held = torch.zeros(R, dtype=torch.int32, device=values.device)
    for (o, f), c in need.items():
        cnt = ((values == o) | (values == f)).sum(dim=1, dtype=torch.int32)
        held += cnt.clamp(max=c)
    slack = 0 if (literal or max_typos is None) else int(max_typos)
    return held >= len(pairs) - slack


class Work(NamedTuple):
    """One query's work: its operations; per unit mode the rows alive;
    the operations past the DP's cap; per unit mode the rows scanned
    greedily and their windows' bytes."""

    ops: float
    alive: Dict[bool, torch.Tensor]
    past_ops: float
    greedy: Dict[bool, Tuple[torch.Tensor, torch.Tensor]]


class Bound(NamedTuple):
    """One batch's least time and what it is counted from; ``past_*`` is
    the part past the DP's cap."""

    seconds: float
    what: str
    in_bytes: float
    out_bytes: float
    ops: float
    past_in_bytes: float
    past_ops: float


def over_cap_rows(corpus: Corpus) -> torch.Tensor:
    """Rows over ``XL_UNITS`` codepoints (the units a deployment packs:
    bytes of an ASCII corpus, codepoints of a unicode one)."""
    chars = np.fromiter(map(len, corpus.strings), np.int64, len(corpus))
    return torch.from_numpy(chars > XL_UNITS).to(corpus.device)


def query_work(corpus: Corpus, query: str, config: dict,
               over_cap: Optional[torch.Tensor] = None) -> Work:
    """The work of one query; a literal atom reads bytes in either mode.
    ``over_cap`` is ``over_cap_rows(corpus)``, worked out once."""
    max_typos = config.get("max_typos", 0)
    scoring = {**DEFAULT_SCORING, **config.get("scoring", {})}
    if over_cap is None:
        over_cap = over_cap_rows(corpus)
    alive_in = {}
    scans = {}
    ops = past = 0.0
    for atom in parse_query(query):
        literal = atom.mode != FUZZY
        mode = atom.unicode and not literal
        units = corpus.units(mode)
        if mode not in alive_in:
            alive_in[mode] = torch.zeros(len(corpus), dtype=torch.bool,
                                         device=corpus.device)
        n = len(atom.orig)
        for blk in units.blocks(BLOCK_CELLS):
            xl = over_cap[blk.rows]
            if literal:
                vals = units.byte_block(blk.rows)
                alive = _alive(vals, atom, None, True)
                cols = blk.n_bytes.clamp(max=n) if atom.mode in (
                    EXACT, PREFIX) else blk.n_bytes
                per = LIT_OPS_PER_CELL * n + LIT_OPS_PER_COLUMN
                ops += float((cols * alive).sum()) * per
                past += float((cols * (alive & xl)).sum()) * per
            else:
                alive = _alive(blk.cp, atom, max_typos, False)
                per = prefilter_ops_per_column(n, max_typos)
                ops += float((blk.n_units * alive).sum()) * per
                past += float((blk.n_units * (alive & xl)).sum()) * per
                kept, sub, _wf, wlen, _ctx, ws, we = fuzzy_window(
                    blk, atom, max_typos)
                over = (we - ws) > MAX_WINDOW_BYTES
                cells = torch.where(over, 0, wlen)
                ops += float(cells.sum()) * n * SW_OPS_PER_CELL
                past += float((cells * xl[kept]).sum()) * n * SW_OPS_PER_CELL
                g = torch.nonzero(over).flatten()
                if len(g):
                    rows = sub.rows[g]
                    scan = greedy_windows(units.byte_windows, rows, ws[g],
                                          we[g], atom, scoring)
                    scanned = float(scan.scanned.sum()) * GREEDY_OPS_PER_BYTE
                    ops += scanned
                    past += scanned
                    scans.setdefault(mode, []).append(
                        (rows, (we - ws)[g].long()))
            alive_in[mode][blk.rows] |= alive
    greedy = {mode: (torch.cat([r for r, _ in got]),
                     torch.cat([b for _, b in got]))
              for mode, got in scans.items()}
    return Work(ops, alive_in, past, greedy)


def batch_bounds(corpus: Corpus, batches: Sequence[Sequence[str]],
                 config: dict, k: int):
    """Per batch its ``Bound``."""
    over_cap = over_cap_rows(corpus)
    cache = {}
    out = []
    for batch in batches:
        ops = past_ops = 0.0
        read = {}
        longest = {}
        for q in batch:
            if q not in cache:
                cache[q] = query_work(corpus, q, config, over_cap)
            work = cache[q]
            ops += work.ops
            past_ops += work.past_ops
            for mode, alive in work.alive.items():
                read[mode] = read[mode] | alive if mode in read else alive
            for mode, (rows, nbytes) in work.greedy.items():
                if mode not in longest:
                    longest[mode] = torch.zeros(len(corpus), dtype=torch.long,
                                                device=corpus.device)
                longest[mode].scatter_reduce_(0, rows, nbytes, "amax")
        in_bytes = past_in = 0.0
        for mode, rows in read.items():
            units = corpus.units(mode).n_units.to(torch.float64)
            in_bytes += ((4 if mode else 1) * float((units * rows).sum())
                         + 8 * float(rows.sum()))
            xl = rows & over_cap
            past_in += ((4 if mode else 1) * float((units * xl).sum())
                        + 8 * float(xl.sum()))
            if mode in longest:
                if mode:  # the UTF-8 bytes beside the codepoints
                    in_bytes += float(longest[mode].sum())
                    past_in += float(longest[mode].sum())
                else:  # within the byte units counted above
                    past_in += float((longest[mode] * ~over_cap).sum())
        out_bytes = 8.0 * len(batch) * (1 + k)
        ms, what = _bound(in_bytes, out_bytes, ops)
        out.append(Bound(ms / 1e3, what, in_bytes, out_bytes, ops, past_in,
                         past_ops))
    return out


def served_least_s(run) -> float:
    """The least time of every batch the run's window served, in
    seconds (the bounds of the cell's fixed batches, summed as
    served)."""
    mix = run.cell.mix
    bounds = batch_bounds(run.ref_corpus, run.batches, mix["config"],
                          mix["k"])
    return sum(bounds[b][0] for b, *_ in run.served)
