"""Profiling helpers.

Counterpart of ``frizbee_tpu/profiling.py`` on ``torch.profiler``:
``trace`` writes a Chrome trace of the enclosed block (host operations,
and the card's kernels and copies where there is a card) to a standard
place, ``annotate`` names a region of it, and ``wall_time`` is the
host-clock median of blocking calls. ``probes.device_ms`` is the other
clock: CUDA events around queued launches, the device's own time.

The batched serving path (``matcher.py``) carries its own spans, one set
a batch, each name followed by ``#<batch serial>``:

- ``frizbee.dispatch``, all of ``match_topk_batch_async``, holding
  ``frizbee.compile`` (the queries' Matcher builds), ``frizbee.group``
  (grouping by shape) and, a shape group each, ``frizbee.cap`` (the
  finalize-cap chooser), ``frizbee.upload`` (the needles to the card),
  ``frizbee.enqueue`` (the device pass) and ``frizbee.copy_back`` (the
  pinned copy of the result started);
- ``frizbee.result``, all of ``BatchFuture.result()``, holding
  ``frizbee.wait`` (a shape group's copy awaited), ``frizbee.decode``
  (its rows decoded) and ``frizbee.fixups`` (the host fixups and any
  per-query fallback).

They cost a check of the profiler's state and nothing else while no
profiler records. An operator gets them with the card's work beside them
by serving inside ``trace``::

    with profiling.trace("serve"):
        for batch in batches:
            match_topk_batch_async(batch, corpus).result()

and opens the written file in Perfetto (https://ui.perfetto.dev).
``matcher.SERVING_COUNTS`` counts the same path's batches, queries,
device passes, stage-1 alive pairs and per-query fallbacks.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

# what annotate returns while no profiler records: entered and left
# again by every span, it holds no state
_NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str, serial: Optional[int] = None):
    """Named region inside a trace, ``<name>#<serial>`` where a serial is
    given. While a profiler records it is a ``RecordFunction`` range on
    the profiler's clock, which the card's events share, and an NVTX
    range on the card; otherwise a shared no-op context (a check of the
    profiler's state, nothing entered or allocated). The range is of
    the function scope, as an operator's: a user-scope range would also
    leave a copy on the card's timeline, spanning the device work
    launched inside it, which a reader of device events would count as
    busy time."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    if serial is not None:
        name = f"{name}#{serial}"
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str) -> Iterator[None]:
    with _RecordFunctionFast(name):
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


def wall_time(fn, *args, iters: int = 10, **kwargs) -> float:
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
