"""Probe: the exact block-min tournament top-k of the broad finalize
route, against the full sort and ``torch.topk``, on the card.

    python -m frizbee_tpu_torch.probes.broad_topk [--device cpu]

Counterpart of ``benchmarks/probe_broad_topk.py`` (its ``row_gather``
:50, ``pallas_call`` :93, and ``tournament_topk`` :103). The tournament is
the serving path's own ``ops/batch._broad_topk`` at R = 64 and 128: block
minima over R-key blocks, the ``fetch`` blocks of smallest minima
gathered by the CUDA row gather (``csrc/row_gather.cu``; int64 keys as
int32 pairs, one 2R-word row a block) and sorted. The keys are the
reference's: (16, 1,048,576) int64, seed 0, 35% matched rows keyed
``((0xFFFF - score) << 36) | (row << 16)``, the rest the int64 maximum.

Prints, one JSON object a line: ``{"R", "exact_equal"}`` per R (the
tournament equals ``torch.sort``'s first ``fetch`` keys), then
``full_sort_ms``, ``tournament_ms`` per R, ``blockmin_sort_ms`` (the
block minima and the selection of the ``fetch`` smallest, R = 128) and
``gather_only_ms_R128`` (the row gather of ``Q * fetch`` random 256-word
rows of the keys). New beside the reference's: ``torch.topk(...,
largest=False, sorted=True)``, one library call that computes the whole
function (``topk_equal``, ``topk_ms``), and ``torch.index_select`` on the
gather's arguments (``gather_equal``, ``index_select_ms_R128``). The
reference's ``G`` (8 or 16 rows a grid step) batches TPU DMAs and has no
counterpart here, so its per-G lines are one line per R.

With ``--device cpu`` every step runs its plain version (the gather is
``row_gather_plain``) and times print as null; on the card the gather is
the kernel, with no fallback.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.batch import _broad_topk
from ..ops.colstream import row_gather
from . import emit, median_ms, resolve_device

Q, T, FETCH = 16, 1_048_576, 2048
TOURNAMENT_R = (64, 128)
GATHER_R = 128
SENT = np.int64(0x7FFFFFFFFFFFFFFF)


def make_keys(rng, q: int = Q, t: int = T) -> np.ndarray:
    """The reference's keys, drawn from ``rng`` in its order: (q, t) int64,
    ~35% matched rows with a score in [0, 520) and their row index, the
    rest the sentinel. Keys stay unique below t = 2^20 rows."""
    idx = np.arange(t, dtype=np.int64)
    score = rng.integers(0, 520, (q, t)).astype(np.int64)
    matched = rng.random((q, t)) < 0.35
    return np.where(matched, ((0xFFFF - score) << 36) | (idx << 16)[None, :],
                    SENT)


def _blockmin_select(keys, fetch, R):
    q, t = keys.shape
    bm = keys.reshape(q, t // R, R).amin(dim=2)
    return torch.argsort(bm, dim=1)[:, :fetch]


def run(device, *, q=Q, t=T, fetch=FETCH, reps=10, seed=0):
    """Yield the probe's records (see the module docstring); the last
    three steps time the gather alone, as the reference does."""
    for R in TOURNAMENT_R + (GATHER_R,):
        if t % R or fetch > t // R:
            raise ValueError(f"t={t} holds fewer than fetch={fetch} "
                             f"blocks of R={R}")
    rng = np.random.default_rng(seed)
    k64 = torch.from_numpy(make_keys(rng, q, t)).to(device)
    full = torch.sort(k64, dim=1).values[:, :fetch]
    for R in TOURNAMENT_R:
        got = _broad_topk(k64, fetch_rows=fetch, R=R)
        yield {"R": R, "exact_equal": bool(torch.equal(got, full))}
    top = torch.topk(k64, fetch, dim=1, largest=False, sorted=True).values
    yield {"topk_equal": bool(torch.equal(top, full))}
    del got, top, full

    yield {"full_sort_ms": median_ms(lambda: torch.sort(k64, dim=1), device,
                                     reps)}
    for R in TOURNAMENT_R:
        yield {"R": R, "tournament_ms": median_ms(
            lambda R=R: _broad_topk(k64, fetch_rows=fetch, R=R), device,
            reps)}
    yield {"topk_ms": median_ms(
        lambda: torch.topk(k64, fetch, dim=1, largest=False, sorted=True),
        device, reps)}
    yield {"blockmin_sort_ms": median_ms(
        lambda: _blockmin_select(k64, fetch, GATHER_R), device, reps)}

    flat, rows = _gather_operands(k64, rng, fetch)
    yield {"gather_equal": bool(torch.equal(
        row_gather(flat, rows), torch.index_select(flat, 0, rows)))}
    yield {"gather_only_ms_R128": median_ms(lambda: row_gather(flat, rows),
                                            device, reps)}
    yield {"index_select_ms_R128": median_ms(
        lambda: torch.index_select(flat, 0, rows), device, reps)}


def _gather_operands(k64, rng, fetch):
    """The gather-alone step's (data, rows): the (q, t) keys as (q t / 128,
    256) int32 rows, and ``q * fetch`` row ids drawn from ``rng`` after the
    keys, as the reference draws them."""
    q, t = k64.shape
    rows = rng.integers(0, q * t // GATHER_R, q * fetch, dtype=np.int32)
    return (k64.view(torch.int32).reshape(q * t // GATHER_R, 2 * GATHER_R),
            torch.from_numpy(rows).to(k64.device))


def gather_args(device, *, q=Q, t=T, fetch=FETCH, seed=0):
    """The gather-alone step's (data, rows) as :func:`run` makes them."""
    rng = np.random.default_rng(seed)
    k64 = torch.from_numpy(make_keys(rng, q, t)).to(device)
    return _gather_operands(k64, rng, fetch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(resolve_device(a.device)))


if __name__ == "__main__":
    sys.exit(main())
