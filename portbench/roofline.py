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
  unit (the reference's own prefilter and window decide both);
- a literal atom walks each alive row's columns (only the first n for
  exact and prefix), n cells a column and a per-column cost.

Bytes: every unit of a row alive for some query of the batch, once (1
byte a byte unit, 4 a codepoint), and 8 bytes a row so read (its index
and unit count); written: a (1 + k)-row answer of 8-byte entries a
query. The bound is the larger of the bytes' time and the operations'.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference.fuzzy import fuzzy_window
from portbench.reference.query import EXACT, FUZZY, PREFIX, parse_query
from portbench.reference.serve import BLOCK_CELLS, Corpus

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


def query_work(corpus: Corpus, query: str, config: dict):
    """(operations, {unit mode: rows alive (N,) bool}) of one query; a
    literal atom reads bytes in either mode."""
    max_typos = config.get("max_typos", 0)
    alive_in = {}
    ops = 0.0
    for atom in parse_query(query):
        literal = atom.mode != FUZZY
        mode = atom.unicode and not literal
        units = corpus.units(mode)
        if mode not in alive_in:
            alive_in[mode] = torch.zeros(len(corpus), dtype=torch.bool,
                                         device=corpus.device)
        n = len(atom.orig)
        for blk in units.blocks(BLOCK_CELLS):
            if literal:
                vals = units.byte_block(blk.rows)
                alive = _alive(vals, atom, None, True)
                cols = blk.n_bytes.clamp(max=n) if atom.mode in (
                    EXACT, PREFIX) else blk.n_bytes
                ops += float((cols * alive).sum()) * (
                    LIT_OPS_PER_CELL * n + LIT_OPS_PER_COLUMN)
            else:
                alive = _alive(blk.cp, atom, max_typos, False)
                ops += float((blk.n_units * alive).sum()) * (
                    prefilter_ops_per_column(n, max_typos))
                _kept, _sub, _wf, wlen, *_ = fuzzy_window(blk, atom,
                                                          max_typos)
                ops += float(wlen.sum()) * n * SW_OPS_PER_CELL
            alive_in[mode][blk.rows] |= alive
    return ops, alive_in


def batch_bounds(corpus: Corpus, batches: Sequence[Sequence[str]],
                 config: dict, k: int):
    """Per batch (bound seconds, what bounds it, in bytes, out bytes,
    operations)."""
    cache = {}
    out = []
    for batch in batches:
        ops = 0.0
        read = {}
        for q in batch:
            if q not in cache:
                cache[q] = query_work(corpus, q, config)
            q_ops, alive_in = cache[q]
            ops += q_ops
            for mode, alive in alive_in.items():
                read[mode] = read[mode] | alive if mode in read else alive
        in_bytes = 0.0
        for mode, rows in read.items():
            units = corpus.units(mode).n_units.to(torch.float64)
            in_bytes += ((4 if mode else 1) * float((units * rows).sum())
                         + 8 * float(rows.sum()))
        out_bytes = 8.0 * len(batch) * (1 + k)
        ms, what = _bound(in_bytes, out_bytes, ops)
        out.append((ms / 1e3, what, in_bytes, out_bytes, ops))
    return out


def served_least_s(run) -> float:
    """The least time of every batch the run's window served, in
    seconds (the bounds of the cell's fixed batches, summed as
    served)."""
    mix = run.cell.mix
    bounds = batch_bounds(run.ref_corpus, run.batches, mix["config"],
                          mix["k"])
    return sum(bounds[b][0] for b, *_ in run.served)
