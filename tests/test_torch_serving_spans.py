"""The batched serving path's spans and counts (``frizbee_tpu_torch``'s
``profiling.annotate`` and ``matcher.SERVING_COUNTS``) on the CPU, and
the benchmark's reading of them (``portbench/program_spans.py`` and the
two counter metrics): span names, nesting and the batch serial from a
``torch.profiler`` run; nothing entered while no profiler records; the
counts after a known batch; the readers on synthetic events and runs."""

import os
import types

import pytest
import torch

from frizbee_tpu_torch import (
    Config,
    match_topk_batch,
    match_topk_batch_async,
    matcher,
    pack_corpus,
    profiling,
)
from portbench import harness, program_spans
from portbench.program_spans import ProgramTracer
from portbench.trace import Tracer

ROWS = ["foo/bar.rs", "bar/baz.py", "src/foo.c", "barn", "a/b/c.txt",
        "foobar", "zzz", "baz_foo.h"]
# three shape groups (3-, 2- and 5-byte needles) and the empty query,
# which no group takes: the per-query path serves it
QUERIES = ["foo", "bar", "qqq", "ba", "fooba", ""]
N_GROUPS = 3
STEPS = {"dispatch", "compile", "group", "cap", "upload", "enqueue",
         "result", "decode", "fixups"}
DISPATCH_STEPS = {"compile", "group", "cap", "upload", "enqueue"}
RESULT_STEPS = {"decode", "fixups"}


@pytest.fixture(scope="module")
def corpus():
    return pack_corpus(ROWS, device="cpu")


def program_events(prof):
    """(step, serial, start, end, user annotation) of the profiler's
    ``frizbee.*`` events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("frizbee."):
            step, serial = program_spans.split_serial(
                e.name()[len("frizbee."):])
            start = e.start_ns()
            out.append((step, serial, start, start + e.duration_ns(),
                        e.is_user_annotation()))
    return out


def test_spans_nest_and_share_the_batch_serial(corpus, tmp_path):
    with profiling.trace("serve", log_dir=str(tmp_path)) as prof:
        futures = [match_topk_batch_async(QUERIES, corpus, Config(), k=4)
                   for _ in range(2)]
        for f in futures:
            f.result()
    events = program_events(prof)
    serials = [f.serial for f in futures]
    assert serials[1] == serials[0] + 1
    assert {s for _, s, *_ in events} == set(serials)
    # function-scope ranges: no copy on the card's timeline
    assert not any(user for *_, user in events)
    for serial in serials:
        mine = [e for e in events if e[1] == serial]
        steps = [e[0] for e in mine]
        assert set(steps) == STEPS
        for step in ("dispatch", "compile", "group", "result", "fixups"):
            assert steps.count(step) == 1, step
        for step in ("cap", "upload", "enqueue", "decode"):
            assert steps.count(step) == N_GROUPS, step
        (d,) = [e for e in mine if e[0] == "dispatch"]
        (r,) = [e for e in mine if e[0] == "result"]
        assert d[3] <= r[2]
        for step, _, a, b, _ in mine:
            if step in DISPATCH_STEPS:
                assert d[2] <= a <= b <= d[3], step
            elif step in RESULT_STEPS:
                assert r[2] <= a <= b <= r[3], step
    (path,) = os.listdir(tmp_path)
    with open(tmp_path / path) as fh:
        assert f'"frizbee.dispatch#{serials[0]}"' in fh.read()


def test_wait_and_copy_back_spans():
    """On the CPU no copy is started and none awaited; an event's wait is
    a span of its batch."""
    synced = []
    ready = types.SimpleNamespace(synchronize=lambda: synced.append(1))
    out = torch.arange(6)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert matcher._copy_back(out, 7) == (out, None)
        matcher._wait(None, 7)
        matcher._wait(ready, 7)
    assert synced == [1]
    assert [e[:2] for e in program_events(prof)] == [("wait", 7)]


def test_span_serial_split():
    assert program_spans.split_serial("cap#12") == ("cap", 12)
    assert program_spans.split_serial("cap") == ("cap", None)
    assert program_spans.split_serial("a#b") == ("a#b", None)


def test_annotate_enters_nothing_while_no_profiler_records(corpus,
                                                           monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def counting_record_function(name, *args, **kwargs):
        entered.append(name)
        return Counting(name)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting_record_function)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a", 1) is profiling.annotate("b")
    match_topk_batch(QUERIES, corpus, Config(), k=4)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        match_topk_batch(QUERIES, corpus, Config(), k=4)
    assert {n.split("#")[0] for n in entered} == {"frizbee." + s
                                                  for s in STEPS}


def fresh_counts(monkeypatch):
    counts = dict.fromkeys(matcher.SERVING_COUNTS, 0)
    monkeypatch.setattr(matcher, "SERVING_COUNTS", counts)
    return counts


@pytest.mark.parametrize("max_typos,alive", [
    # "qqq" is alive in no group: no row holds a q
    (0, 4),
    # no prefilter: every (group, query) pair is alive
    (None, 5),
])
def test_serving_counts_after_a_known_batch(corpus, monkeypatch, max_typos,
                                            alive):
    groups = sum(b.host_blk_bits().shape[0] for b in corpus.buckets)
    assert groups == 1
    counts = fresh_counts(monkeypatch)
    match_topk_batch(QUERIES, corpus, Config(max_typos=max_typos), k=4)
    assert counts == {"batches": 1, "queries": 6, "groups": N_GROUPS,
                      "alive_pairs": alive * groups,
                      "cap_pairs": 5 * groups, "fallback_queries": 1}


MS = 1_000_000


class FakeEvent:
    def __init__(self, name, start_ms, end_ms, cuda=False):
        self._name, self._cuda = name, cuda
        self._start, self._dur = start_ms * MS, (end_ms - start_ms) * MS

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)


def synthetic_events():
    """One batch in a 100 ms window: the benchmark's spans and their card
    copies, the program's spans (a blocking upload inside the dispatch),
    the runtime's calls, kernels and a copy of a user-scope range."""
    return [
        FakeEvent("portbench.window", 0, 100),
        FakeEvent("portbench.dispatch", 0, 40),
        FakeEvent("portbench.dispatch", 0, 40, cuda=True),
        FakeEvent("portbench.result", 50, 90),
        FakeEvent("frizbee.dispatch#5", 1, 39),
        FakeEvent("frizbee.compile#5", 1, 11),
        FakeEvent("frizbee.group#5", 11, 15),
        FakeEvent("frizbee.cap#5", 15, 25),
        FakeEvent("frizbee.upload#5", 25, 33),
        FakeEvent("cudaMemcpyAsync", 26, 27),
        FakeEvent("cudaStreamSynchronize", 27, 32),
        FakeEvent("frizbee.enqueue#5", 33, 37),
        FakeEvent("cudaLaunchKernel", 34, 35),
        FakeEvent("frizbee.copy_back#5", 37, 38),
        FakeEvent("frizbee.result#5", 50, 89),
        FakeEvent("frizbee.wait#5", 51, 70),
        FakeEvent("cudaEventSynchronize", 51, 70),
        FakeEvent("frizbee.decode#5", 70, 80),
        FakeEvent("frizbee.fixups#5", 80, 88),
        FakeEvent("aten::stack", 26, 27),
        FakeEvent("void colstream_fuzzy_kernel<4, false>(Args)", 0, 20,
                  cuda=True),
        FakeEvent("void at::native::sort_kernel", 45, 60, cuda=True),
        FakeEvent("user.range", 0, 20, cuda=True),
    ]


def traced(tracer_cls, events):
    tracer = tracer_cls(True)
    tracer._prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return tracer.result()


def test_program_tracer_keeps_the_lists_of_the_benchmark_tracer():
    events = synthetic_events()
    base, prog = traced(Tracer, events), traced(ProgramTracer, events)
    assert prog.device == base.device and prog.spans == base.spans
    assert [s[0] for s in prog.spans] == ["window", "dispatch", "result"]
    assert len(prog.program) == 11
    assert {s[1] for s in prog.program} == {5}
    assert [s[0] for s in prog.syncs] == ["cudaStreamSynchronize",
                                          "cudaEventSynchronize"]


def test_program_span_readings():
    trace = traced(ProgramTracer, synthetic_events())
    got = program_spans.step_ms(trace, 2)
    assert got == pytest.approx({
        "host_compile_ms": 10 / 2,
        "host_cap_ms": 10 / 2,
        # group 4 + upload 8 + enqueue 4 + copy_back 1, less the 5 ms
        # synchronize inside the upload
        "host_enqueue_ms": 12 / 2,
        "dispatch_wait_ms": 5 / 2,
        "result_wait_ms": 19 / 2,
        "host_decode_ms": 18 / 2,
    })
    # dispatch 38 of 40 ms, result 39 of 40
    assert program_spans.coverage(trace) == pytest.approx(77 / 80)
    idle = program_spans.idle_by_step(trace)
    # gaps: 20-45 (midpoint 32.5 in the upload), 60-100 (midpoint 80:
    # the decode ends, the fixups start)
    assert idle == pytest.approx({"dispatch/upload": 0.025,
                                  "result/fixups": 0.040})
    assert program_spans.labelled_share(idle) == 1.0
    assert program_spans.labelled_share({"dispatch": 1.0,
                                         "dispatch/cap": 3.0,
                                         "loop": 5.0}) == 0.75


def test_program_span_readings_empty_on_a_program_without_spans():
    events = [e for e in synthetic_events()
              if not e.name().startswith("frizbee.")]
    trace = traced(ProgramTracer, events)
    assert program_spans.step_ms(trace, 2) == {}
    assert program_spans.coverage(trace) == 0.0
    assert set(program_spans.idle_by_step(trace)) == {"dispatch", "result"}
    assert program_spans.labelled_share(
        program_spans.idle_by_step(trace)) == 0.0


@pytest.mark.parametrize("name,counts,value", [
    ("groups_per_batch", {"batches": 4, "groups": 32}, 8.0),
    ("stage1_alive_share", {"alive_pairs": 30, "cap_pairs": 120}, 0.25),
])
def test_counter_metric_reads_the_program(monkeypatch, name, counts, value):
    read = harness.load_module("metrics", name).read
    fresh_counts(monkeypatch).update(counts)
    assert read(None) == pytest.approx(value)
    fresh_counts(monkeypatch)
    assert read(None) is None
    monkeypatch.delattr(matcher, "SERVING_COUNTS")
    assert read(None) is None
