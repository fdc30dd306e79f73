"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that the harness finds by the name ``BENCHMARK.json``
gives: ``configs/<config>.json`` (its ``generator`` in
``corpora/<generator>.py``), ``traffic/<traffic>.json`` (its
``generator`` in ``traffic/<generator>.py``) and ``metrics/<metric>.py``
(a ``read(run)`` that returns the metric's value, or None where it finds
nothing to read).

The system under test is ``frizbee_tpu_torch``'s batched top-k serving:
a corpus packed once (``pack_corpus``) answers batches of queries through
``match_topk_batch_async`` and ``BatchFuture.result()``. The window is a
closed loop that keeps ``depth`` batches in flight, cycling through the
traffic's fixed set of batches; it stops dispatching once ``seconds``
have passed and ends when the last batch in flight has answered.

A workload on more than one chip serves through the single-controller
mesh instead: ``parallel.make_mesh(chips)`` puts one shard of the corpus
on each card, and every batch is one synchronous
``parallel.match_topk_batch_sharded`` call, so one batch is in flight
whatever the mix's ``depth``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import check
from portbench.trace import Trace, Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "frizbee_tpu")
# independent random streams drawn from one seed
CORPUS_STREAM, TRAFFIC_STREAM, ORDER_STREAM, SAMPLE_STREAM = range(4)
# every seed serves one fixed set of queries a mix, drawn from this many
# rows of the configuration's generator at this seed (see traffic())
TRAFFIC_SEED, TRAFFIC_ROWS = 20261018, 20000


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 63), stream]))


@dataclass
class Cell:
    name: str
    spec: dict
    workload: dict
    config: dict
    mix: dict

    @classmethod
    def load(cls, name: str, spec: Optional[dict] = None,
             overrides: Optional[dict] = None) -> "Cell":
        """The cell ``name`` of ``BENCHMARK.json`` with its configuration
        and traffic mix; ``overrides`` = {"config": {...}, "mix": {...}}
        replaces top-level keys (the tests' small sizes)."""
        spec = spec or load_json(ROOT, "BENCHMARK.json")
        wl = next((w for w in spec["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg_entry = next(c for c in spec["configs"]
                         if c["name"] == wl["config"])
        config = load_json(ROOT, cfg_entry["file"])
        mix = load_json(HERE, "traffic", f"{wl['traffic']}.json")
        overrides = overrides or {}
        config.update(overrides.get("config", {}))
        mix.update(overrides.get("mix", {}))
        return cls(name, spec, wl, config, mix)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a run (end-to-end, or
        per-layer with ``trace``)."""
        entries = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if self.name in m.get("workloads", [self.name])]


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    n_rows: int = 0
    batches: List[List[str]] = field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    # per served batch: (batch index, submit time, dispatch seconds,
    # latency seconds)
    served: List[tuple] = field(default_factory=list)
    # the fullest card's peak, and each card's
    peak_bytes: int = 0
    card_peaks: List[int] = field(default_factory=list)
    trace: Optional[Trace] = None
    ref_corpus: object = None
    counters: Dict[str, dict] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0

    @property
    def queries_served(self) -> int:
        return sum(len(self.batches[b]) for b, *_ in self.served)


def process_start_time() -> Optional[float]:
    """The wall time this process started, from /proc (None where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def traffic(cell: Cell, gen, seed: int):
    """(batches, shape label of each query): the mix's fixed set of
    queries, drawn once from ``TRAFFIC_ROWS`` rows of the configuration's
    generator at ``TRAFFIC_SEED``, then dealt into the batches anew for
    each seed. Every seed serves the same queries in the same shape
    groups, in other batches and another order: the seed changes the
    inputs, not the amount of work."""
    mix = cell.mix
    rows = gen.generate(**{**cell.config["params"],
                           "num_samples": TRAFFIC_ROWS}, seed=TRAFFIC_SEED)
    tgen = load_module("traffic", mix["generator"])
    batches, shapes = tgen.generate(rows, mix["params"], mix["batches"],
                                    np.random.default_rng(TRAFFIC_SEED))
    rng = rng_for(seed, TRAFFIC_STREAM)
    slots = [(b, j) for b, batch in enumerate(batches)
             for j in range(len(batch))]
    dealt = [list(batch) for batch in batches]
    for label in sorted(set(shapes.values())):
        mine = [(b, j) for b, j in slots if shapes[batches[b][j]] == label]
        queries = [batches[b][j] for b, j in mine]
        for (b, j), i in zip(mine, rng.permutation(len(queries))):
            dealt[b][j] = queries[i]
    for batch in dealt:
        rng.shuffle(batch)
    return dealt, shapes


def port_config(fields: dict):
    """``frizbee_tpu_torch.Config`` of the mix's Config fields."""
    from frizbee_tpu_torch import Config, Scoring

    fields = dict(fields)
    if "scoring" in fields:
        fields["scoring"] = Scoring(**fields["scoring"])
    return Config(**fields)


class Done:
    """An answered batch in the place of a ``BatchFuture``: ``result()``
    hands back the answers, or raises what the call raised."""

    def __init__(self, call: Callable):
        try:
            self._answers, self._error = call(), None
        except Exception as exc:  # a batch that raises has failed
            self._answers, self._error = None, exc

    def result(self):
        if self._error is not None:
            raise self._error
        return self._answers


class Session:
    """A cell set up in this process: the packed corpus and the traffic,
    warmed up; windows can then be served. On more than one chip the
    corpus, packed on the first card, is served by a mesh of one shard
    a card (on the CPU: that many shards on the one device)."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 t_start: Optional[float] = None):
        import torch

        from frizbee_tpu_torch import pack_corpus, parallel

        self.device = device
        mix = cell.mix
        self.phases = {}
        t = time.perf_counter()
        gen = load_module("corpora", cell.config["generator"])
        self.rows = gen.generate(**cell.config["params"],
                                 seed=int(rng_for(seed, CORPUS_STREAM)
                                          .integers(1 << 62)))
        t = self._phase("generate", t)
        self.corpus = pack_corpus(self.rows, unicode=cell.config["unicode"],
                                  device=device)
        t = self._phase("pack", t)
        self.batches, self.shapes = traffic(cell, gen, seed)
        self.order = rng_for(seed, ORDER_STREAM).permutation(
            len(self.batches))
        self.sampled = check.sample(
            self.shapes, mix["params"].get("fixed", []),
            mix["check_per_shape"], rng_for(seed, SAMPLE_STREAM))
        self.port_cfg = port_config(mix["config"])
        self.k = mix["k"]
        self.mesh = None
        self.depth = mix["depth"]
        if cell.chips > 1:
            self.mesh = parallel.make_mesh(
                cell.chips, device=None if device == "cuda" else device)
            self.depth = 1  # each call returns its answers
        t = self._phase("traffic", t)
        # warm-up: every batch of the set once, through the same loop (on
        # a mesh this also moves each shard's rows to its card)
        self.serve(0.0, max_batches=len(self.batches))
        if device == "cuda":
            for dev in (self.mesh.devices if self.mesh else [None]):
                torch.cuda.synchronize(dev)
        self._phase("warm_up", t)
        self.setup_s = time.time() - t_start if t_start is not None else None

    def _phase(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.phases[name] = t - t0
        return t

    def serve(self, seconds: float, max_batches: Optional[int] = None,
              ledger: Optional[check.Ledger] = None,
              tracer: Optional[Tracer] = None,
              fault: Optional[Callable] = None):
        """The closed loop; returns (window seconds, served records,
        batches that raised)."""
        from frizbee_tpu_torch import (match_topk_batch_async,
                                       match_topk_batch_sharded)

        tracer = tracer or Tracer(False)
        inflight = deque()
        served, failed = [], 0
        previous = None
        B = len(self.order)

        def collect():
            nonlocal previous, failed
            b, ts, dispatch_s, fut = inflight.popleft()
            with tracer.span("result"):
                try:
                    answers = fut.result()
                except Exception as exc:  # a batch that raises has failed
                    print(f"batch {b} raised: {exc!r}", file=sys.stderr)
                    answers, failed = None, failed + 1
            done = time.perf_counter()
            with tracer.span("traffic"):
                if fault is not None and answers is not None:
                    got = fault(answers, previous)
                    previous, answers = answers, got
                served.append((b, ts, dispatch_s, done - ts))
                if ledger is not None:
                    ledger.record(self.batches[b], answers)

        i = 0
        with tracer.span("window"):
            t0 = time.perf_counter()
            while (time.perf_counter() - t0 < seconds if max_batches is None
                   else i < max_batches):
                with tracer.span("traffic"):
                    b = int(self.order[i % B])
                    i += 1
                with tracer.span("dispatch"):
                    ts = time.perf_counter()
                    if self.mesh is None:
                        fut = match_topk_batch_async(
                            self.batches[b], self.corpus, self.port_cfg,
                            self.k)
                    else:
                        fut = Done(lambda: match_topk_batch_sharded(
                            self.batches[b], self.corpus, self.mesh,
                            self.port_cfg, self.k))
                    dispatch_s = time.perf_counter() - ts
                inflight.append((b, ts, dispatch_s, fut))
                if len(inflight) >= self.depth:
                    collect()
            while inflight:
                collect()
            window_s = time.perf_counter() - t0
        return window_s, served, failed

    def release(self):
        """Free the program's state (before the reference runs): the
        corpus, and on a mesh the shard views it keeps."""
        import torch

        self.corpus = self.mesh = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def counters_snapshot() -> Dict[str, dict]:
    from frizbee_tpu_torch.ops import _build, batch

    return {
        "launches": dict(_build.LAUNCHES),
        "finalize_routes": dict(batch.FINALIZE_ROUTES),
        "colstream_flows": dict(batch.COLSTREAM_FLOWS),
        "row_major_routes": dict(batch.ROW_MAJOR_ROUTES),
        "generic_routes": dict(batch.GENERIC_ROUTES),
    }


def reset_counters() -> None:
    from frizbee_tpu_torch.ops import _build, batch

    for d in (_build.LAUNCHES, batch.FINALIZE_ROUTES, batch.COLSTREAM_FLOWS,
              batch.ROW_MAJOR_ROUTES, batch.GENERIC_ROUTES):
        for key in d:
            d[key] = 0


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (by default the
    modules loaded in this process), each compared whole."""
    top = {m.split(".")[0] for m in list(sys.modules if names is None
                                         else names)}
    return sorted(top & set(BANNED))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: Optional[str] = None,
             t_start: Optional[float] = None):
    """One run: (the result line's object, notes for earlier lines: the
    answers checked and, traced, the port's counters)."""
    import torch

    from portbench.reference import Corpus as RefCorpus

    session = Session(cell, seed, device, t_start)
    run = Run(cell, n_rows=len(session.rows), batches=session.batches,
              setup_s=session.setup_s or 0.0)
    ledger = check.Ledger(session.sampled)
    tracer = Tracer(trace)
    if trace:
        reset_counters()
    with tracer.recording():
        run.window_s, run.served, run.failed = session.serve(
            seconds, ledger=ledger, tracer=tracer,
            fault=check.FAULTS[fault] if fault else None)
    if trace:
        run.trace = tracer.result()
        run.counters = counters_snapshot()
    run.attempted = len(run.served)
    if device == "cuda":
        run.card_peaks = [int(torch.cuda.max_memory_allocated(i))
                          for i in range(cell.chips)]
        run.peak_bytes = max(run.card_peaks)
    banned = banned_modules()
    if banned:
        raise SystemExit(
            f"modules of the JAX package or of JAX are loaded: {banned}")
    session.release()
    t = time.perf_counter()
    run.ref_corpus = RefCorpus(session.rows, device)
    found = ledger.compare(check.reference_for(
        run.ref_corpus, cell.mix["config"], cell.mix["k"]))
    session.phases["check"] = time.perf_counter() - t
    t = time.perf_counter()
    checks = {name: {"value": found[name], "limit": limit}
              for name, limit in check.LIMITS.items()}
    correct = (found["answers_checked"] > 0 and run.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in cell.metrics(trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(run, device),
    }
    if trace:
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = checks
    session.phases["metrics"] = time.perf_counter() - t
    notes = {"answers_checked": found["answers_checked"],
             "phases_s": session.phases}
    if trace:
        notes["counters"] = run.counters
    return out, notes


def device_info(run: Run, device: str) -> dict:
    """The result line's ``device``: the fullest card's peak and, traced,
    the busy seconds averaged over the cell's cards (on more than one
    card each card's peak and busy seconds besides)."""
    import torch

    chips = run.cell.chips
    info = {"platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else device),
            "count": chips, "memory_peak_bytes": run.peak_bytes}
    if chips > 1:
        info["card_peak_bytes"] = run.card_peaks
    if run.trace is not None:
        if chips > 1:
            busy = run.trace.card_busy_s(chips)
            info["busy_s"] = sum(busy) / chips
            info["card_busy_s"] = busy
        else:
            info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s()
    return info


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (the benchmark's innermost span at each
    gap's midpoint)."""
    ops: Dict[str, float] = {}
    w0, w1 = trace.window()
    for name, a, b in trace.device:
        if b > w0 and a < w1:
            ops[name] = ops.get(name, 0.0) + (min(b, w1) - max(a, w0)) / 1e9
    spans = sorted((s for s in trace.spans if s[0] != "window"),
                   key=lambda s: s[1])
    starts = np.array([s[1] for s in spans], np.int64)
    idle: Dict[str, float] = {}
    for a, b in trace.idle_gaps():
        # the spans inside the window do not overlap: the one holding the
        # gap's midpoint is the last to start before it, if it has not
        # ended
        mid = (a + b) // 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        label = spans[j][0] if j >= 0 and spans[j][2] >= mid else "loop"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9

    def top(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}
