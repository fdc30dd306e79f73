"""The traced window: ``torch.profiler`` over the benchmark's own spans and
the card's operations, reduced to intervals.

The benchmark marks its spans with ``record_function`` (names
``portbench.<span>``: ``window`` around the whole window, ``dispatch``
around each ``match_topk_batch_async`` (or, on a mesh,
``match_topk_batch_sharded``) call, ``result`` around each
``BatchFuture.result()``, ``traffic`` around the rest of the loop). The
profiler's raw events are read as they are, without building its Python
event tree: device operations (kernels, copies, sets) and those spans,
each as (name, start ns, end ns) on the profiler's one clock, and the
card each device operation ran on.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."

Interval = Tuple[str, int, int]


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)
    # the card index of each entry of ``device``
    cards: List[int] = field(default_factory=list)

    def window(self) -> Tuple[int, int]:
        w = [s for s in self.spans if s[0] == "window"]
        if not w:
            raise ValueError("the trace holds no window span")
        return w[0][1], w[0][2]

    def busy_intervals(self, card: Optional[int] = None
                       ) -> List[Tuple[int, int]]:
        """Merged device intervals, clipped to the window: of every card,
        or of ``card`` alone."""
        w0, w1 = self.window()
        device = self.device if card is None else [
            iv for iv, c in zip(self.device, self.cards) if c == card]
        ivs = sorted((max(a, w0), min(b, w1)) for _, a, b in device
                     if b > w0 and a < w1)
        merged: List[List[int]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self, card: Optional[int] = None) -> float:
        return sum(b - a for a, b in self.busy_intervals(card)) / 1e9

    def card_busy_s(self, chips: int) -> List[float]:
        """The busy seconds of each of cards 0 .. chips - 1; a card with
        no operation in the window reads 0."""
        return [self.busy_s(c) for c in range(chips)]

    def window_s(self) -> float:
        w0, w1 = self.window()
        return (w1 - w0) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window()
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        return gaps


class Tracer:
    """Records the window when ``enabled``; a no-op otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextmanager
    def recording(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        with self._prof:
            yield

    def result(self) -> Trace:
        """The recorded intervals (after the recording closed)."""
        results = self._prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        out = Trace()
        for e in results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if name.startswith(SPAN_PREFIX):
                # a span's copy on the device timeline is no operation
                if e.device_type() != cuda:
                    out.spans.append((name[len(SPAN_PREFIX):], start, end))
            elif e.device_type() == cuda:
                out.device.append((name, start, end))
                # an event that names no card, as a one-card source's
                # stand-in may, ran on card 0
                card = getattr(e, "device_index", None)
                out.cards.append(card() if card else 0)
        return out
