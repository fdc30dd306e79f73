"""The port's own serving spans and counts in one cell's traced window.

    python portbench/program_spans.py --workload <cell> --seed <n> \
        --seconds <s>

Run from the root of a checkout, on a machine with an NVIDIA card. The
program (``frizbee_tpu_torch``) names the steps of its batched serving
path with ``frizbee.<step>#<batch serial>`` ranges while a profiler
records (``profiling.annotate``), and counts batches, shape groups and
stage-1 alive (group, query) pairs in ``matcher.SERVING_COUNTS``.
``trace.Tracer`` keeps only the benchmark's own spans and the card's
operations; ``ProgramTracer`` reads the same profiler events, builds the
same two lists, and keeps besides the program's spans and the CUDA
runtime's synchronizing calls. One window of the cell, served as
``run.py`` serves it, prints one JSON line: each step's host ms a served
batch, the synchronizing calls inside the dispatch, how much of the
benchmark's ``dispatch`` and ``result`` time the program's spans cover,
and the card's idle time by the program step the host was in. A program
without these spans or counts reads as empty, and raises nothing.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.trace import Interval, Trace, Tracer  # noqa: E402

PROGRAM_PREFIX = "frizbee."
# the CUDA runtime's calls that block the host until the card has caught
# up (a blocking cudaMemcpy, not its Async form)
SYNC_CALLS = re.compile(r"(cudaStreamSynchronize|cudaEventSynchronize|"
                        r"cudaDeviceSynchronize|cudaMemcpy)(_v\d+|_ptsz)?")
# the program's outermost spans: one of each a batch
TOP_STEPS = ("dispatch", "result")
# the host's share of enqueueing a batch's device passes
ENQUEUE_STEPS = ("group", "upload", "enqueue", "copy_back")

# (step, batch serial or None, start ns, end ns)
ProgramSpan = Tuple[str, Optional[int], int, int]


def split_serial(name: str) -> Tuple[str, Optional[int]]:
    """(step, batch serial or None) of a program span's name, its
    ``frizbee.`` prefix taken off."""
    base, mark, serial = name.rpartition("#")
    if mark and serial.isdigit():
        return base, int(serial)
    return name, None


@dataclass
class ProgramTrace(Trace):
    program: List[ProgramSpan] = field(default_factory=list)
    syncs: List[Interval] = field(default_factory=list)


class ProgramTracer(Tracer):
    """``Tracer`` that also keeps the program's spans and the runtime's
    synchronizing calls."""

    def result(self) -> ProgramTrace:
        import torch

        base = super().result()
        out = ProgramTrace(device=base.device, spans=base.spans,
                           cards=base.cards)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                continue  # operations and the card's copies of ranges
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if name.startswith(PROGRAM_PREFIX):
                step, serial = split_serial(name[len(PROGRAM_PREFIX):])
                out.program.append((step, serial, start, end))
            elif SYNC_CALLS.fullmatch(name):
                out.syncs.append((name, start, end))
        return out


def _overlap(ivs: List[Tuple[int, int]], a: int, b: int) -> int:
    """Length of [a, b] that the sorted, disjoint ``ivs`` cover."""
    return sum(max(0, min(y, b) - max(x, a)) for x, y in ivs
               if y > a and x < b)


def _merged(ivs) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _in_window(trace: ProgramTrace) -> List[ProgramSpan]:
    w0, w1 = trace.window()
    return sorted((s for s in trace.program if s[2] >= w0 and s[3] <= w1),
                  key=lambda s: (s[2], -s[3]))


def step_ms(trace: ProgramTrace, n_batches: int) -> Dict[str, float]:
    """Host ms a served batch in each measured step (empty where the
    window holds no program span):

    - ``host_compile_ms``: ``compile``'s self time (less the program
      spans inside it);
    - ``host_cap_ms``: ``cap``;
    - ``host_enqueue_ms``: ``group`` + ``upload`` + ``enqueue`` +
      ``copy_back``, less the synchronizing calls inside them;
    - ``dispatch_wait_ms``: the synchronizing calls inside ``dispatch``;
    - ``result_wait_ms``: ``wait``;
    - ``host_decode_ms``: ``decode`` + ``fixups``."""
    spans = _in_window(trace)
    if not spans or n_batches <= 0:
        return {}
    syncs = _merged((a, b) for _, a, b in trace.syncs)

    def total(steps):
        return sum(b - a for s, _, a, b in spans if s in steps)

    def synced(steps):
        return sum(_overlap(syncs, a, b) for s, _, a, b in spans
                   if s in steps)

    starts = [s[2] for s in spans]
    compile_self = 0
    for s, _, a, b in spans:
        if s != "compile":
            continue
        lo = bisect.bisect_right(starts, a)
        hi = bisect.bisect_right(starts, b)
        inner = _merged((x[2], x[3]) for x in spans[lo:hi] if x[3] <= b)
        compile_self += (b - a) - sum(y - x for x, y in inner)
    ns = {
        "host_compile_ms": compile_self,
        "host_cap_ms": total(("cap",)),
        "host_enqueue_ms": total(ENQUEUE_STEPS) - synced(ENQUEUE_STEPS),
        "dispatch_wait_ms": synced(("dispatch",)),
        "result_wait_ms": total(("wait",)),
        "host_decode_ms": total(("decode", "fixups")),
    }
    return {k: v / 1e6 / n_batches for k, v in ns.items()}


def span_ms(trace: ProgramTrace, n_batches: int) -> Dict[str, float]:
    """Each step's whole spans, in host ms a served batch."""
    out: Dict[str, float] = {}
    for step, _, a, b in _in_window(trace):
        out[step] = out.get(step, 0.0) + (b - a) / 1e6 / n_batches
    return out


def coverage(trace: ProgramTrace) -> Optional[float]:
    """The share of the benchmark's ``dispatch`` and ``result`` time that
    the program's outermost spans cover."""
    bench = _merged((a, b) for s, a, b in trace.spans if s in TOP_STEPS)
    total = sum(b - a for a, b in bench)
    if not total:
        return None
    prog = _merged((a, b) for s, _, a, b in _in_window(trace)
                   if s in TOP_STEPS)
    return sum(_overlap(bench, a, b) for a, b in prog) / total


def idle_by_step(trace: ProgramTrace) -> Dict[str, float]:
    """Idle seconds of the card by what the host was doing at each gap's
    midpoint: the benchmark's innermost span (as ``harness.breakdown``
    labels it: ``dispatch``, ``result``, ``traffic`` or ``loop``), then
    ``/<step>`` with the program's innermost span there, if any."""
    bench = sorted((s for s in trace.spans if s[0] != "window"),
                   key=lambda s: s[1])
    bstarts = [s[1] for s in bench]
    prog = _in_window(trace)
    pstarts = [s[2] for s in prog]
    idle: Dict[str, float] = {}
    for a, b in trace.idle_gaps():
        mid = (a + b) // 2
        j = bisect.bisect_right(bstarts, mid) - 1
        label = bench[j][0] if j >= 0 and bench[j][2] >= mid else "loop"
        # the innermost program span holding mid started last among
        # those holding it; the outermost spans do not overlap, so the
        # walk back ends at the first of them
        j = bisect.bisect_right(pstarts, mid) - 1
        while j >= 0:
            step, _, _, end = prog[j]
            if end >= mid:
                label += "/" + step
                break
            if step in TOP_STEPS:
                break
            j -= 1
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return idle


def labelled_share(idle: Dict[str, float]) -> Optional[float]:
    """The share of the idle time in ``dispatch`` or ``result`` that
    carries a program step."""
    inside = {k: v for k, v in idle.items()
              if k.split("/")[0] in TOP_STEPS}
    total = sum(inside.values())
    if not total:
        return None
    return sum(v for k, v in inside.items() if "/" in k) / total


def serving_counts() -> Optional[Dict[str, int]]:
    """A copy of the program's ``matcher.SERVING_COUNTS`` (None where
    the program has none)."""
    from frizbee_tpu_torch import matcher

    counts = getattr(matcher, "SERVING_COUNTS", None)
    return dict(counts) if counts is not None else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(args.workload)
    t = time.time()
    session = harness.Session(cell, args.seed, t_start=t)
    before = serving_counts()
    tracer = ProgramTracer(True)
    with tracer.recording():
        window_s, served, failed = session.serve(args.seconds, tracer=tracer)
    after = serving_counts()
    trace = tracer.result()
    n = len(served)
    dispatch = [b - a for s, a, b in trace.spans if s == "dispatch"]
    idle = idle_by_step(trace)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "batches": n, "failed": failed, "window_s": window_s,
        "setup_s": session.setup_s,
        "device_idle_share": 1.0 - trace.busy_s() / trace.window_s(),
        "host_dispatch_ms": sum(dispatch) / len(dispatch) / 1e6,
        **step_ms(trace, n),
        "span_ms": span_ms(trace, n),
        "program_spans_a_batch": len(_in_window(trace)) / n,
        "program_span_coverage": coverage(trace),
        "idle_labelled_share": labelled_share(idle),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
        "sync_calls": sorted({s for s, _, _ in trace.syncs}),
    }
    if before is not None:
        delta = {k: after[k] - before[k] for k in after}
        out["serving_counts"] = delta
        if delta["batches"]:
            out["groups_per_batch"] = delta["groups"] / delta["batches"]
        if delta["cap_pairs"]:
            out["stage1_alive_share"] = (delta["alive_pairs"]
                                         / delta["cap_pairs"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
