"""Profiling helpers.

Counterpart of ``frizbee_tpu/profiling.py`` on ``torch.profiler``:
``trace`` writes a Chrome trace of the enclosed block (host operations,
and the card's kernels and copies where there is a card) to a standard
place, ``annotate`` names a region of it, and ``device_time`` is the
host-clock median of blocking calls. ``probes.device_ms`` is the other
clock: CUDA events around queued launches, the device's own time.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(name: str = "frizbee",
          log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block::

        with profiling.trace("match_100k"):
            matcher.match_arrays(corpus)

    Writes ``<log_dir>/<name>-<unix seconds>.json`` (default directory:
    ``$FRIZBEE_TPU_TRACE_DIR``, else ``frizbee_tpu_traces`` in the temp
    directory), viewable in Perfetto or ``chrome://tracing``, and yields
    the profiler (its ``key_averages()`` and ``events()``)."""
    log_dir = log_dir or os.environ.get(
        "FRIZBEE_TPU_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "frizbee_tpu_traces"),
    )
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}-{int(time.time())}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    print(f"[frizbee-tpu] trace written to {path}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (a ``record_function`` span, and an
    NVTX range on the card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _sync_result(out, seen=None) -> None:
    """Wait for every card the result's tensors live on."""
    seen = set() if seen is None else seen
    if torch.is_tensor(out):
        if out.is_cuda and out.device not in seen:
            seen.add(out.device)
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _sync_result(x, seen)
    elif isinstance(out, dict):
        for x in out.values():
            _sync_result(x, seen)


def device_time(fn, *args, iters: int = 10, **kwargs) -> float:
    """Median wall seconds per call of ``fn``, after one warm-up call.
    Each call waits for the devices of the tensors it returns, so this is
    a host clock around blocking calls (launch and host time included);
    ``probes.device_ms`` times queued launches on the device."""
    fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync_result(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
