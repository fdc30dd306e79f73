"""The reference's kernel probes, on the card: counterparts of
``benchmarks/probe_broad_topk.py`` (``broad_topk``),
``benchmarks/probe_transposed.py`` and ``probe_transposed_check.py``
(``transposed``), and ``benchmarks/probe_colstream_bisect.py`` and
``probe_colstream_bisect2.py`` (``colstream_bisect``).

Each runs as ``python -m frizbee_tpu_torch.probes.<name>``, on the card by
default (``--device cpu`` runs the plain versions, for the tests), builds
its inputs with numpy from the reference's seed in the reference's draw
order, and prints the reference's JSON keys, one object a line. A check
that fails ends the run with a non-zero exit. Times are CUDA-event
medians on the card; on the CPU they print as null (a host clock is no
device time). The reference's fold-proof carries and K-differences exist
for a remote TPU round trip, which the card does not have.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

# cycles of torch.cuda._sleep per second at the H100 SXM's boost clock
SLEEP_CYCLES_PER_S = 1.98e9


def resolve_device(name: str) -> torch.device:
    """The probe's device: the card unless ``--device cpu``; raises
    without a card rather than drift to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions")
    return device


def device_ms(fn, reps: int = 5, warm: int = 2, median: bool = False,
              device: torch.device | None = None):
    """Device ms of one call of ``fn()``: CUDA events around ``reps`` calls
    that queue behind a device sleep outlasting their enqueue, so the
    host's launch overhead leaves no gaps between them on the card (a
    small launch can be quicker on the card than its Python wrapper on
    the host). The mean over one span of events, or with ``median`` the
    median of per-call events. On a CPU ``device`` ``fn`` runs once and
    the result is None (a host clock is no device time)."""
    if device is not None and device.type != "cuda":
        fn()
        return None
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    n_events = reps if median else 1
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_events)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * reps * host_s * SLEEP_CYCLES_PER_S) + 10_000)
    if median:
        for start, end in events:
            start.record()
            fn()
            end.record()
    else:
        events[0][0].record()
        for _ in range(reps):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    if median:
        return float(np.median([s.elapsed_time(e) for s, e in events]))
    return events[0][0].elapsed_time(events[0][1]) / reps


def median_ms(fn, device, reps: int = 10, warm: int = 2):
    """The probes' time: :func:`device_ms`'s median of ``reps`` calls."""
    return device_ms(fn, reps=reps, warm=warm, median=True, device=device)


def emit(records) -> int:
    """Print each record as a JSON line; 1 as soon as a record's check
    (``exact_equal``, ``correct``, ``ok``, ``*_equal``) is false, else 0."""
    for rec in records:
        print(json.dumps(rec), flush=True)
        if any(v is False for k, v in rec.items()
               if k in ("ok", "correct") or k.endswith("_equal")):
            return 1
    return 0
