"""CPU rehearsal of the harness: everything loads by name, the traffic
repeats for a seed, the metric readers read known values from a
synthetic trace, the result line keeps to its keys, a run without a card
prints nothing, and a run whose timed path is broken, or whose answers
come from the control, is not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import check, control, harness
from portbench.trace import Trace

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.Cell.load(name, SPEC)
    harness.load_module("corpora", cell.config["generator"])
    harness.load_module("traffic", cell.mix["generator"])
    assert cell.metrics(False) and cell.metrics(True)
    assert any(m["name"] == "setup_s" for m in cell.metrics(False))


@pytest.mark.parametrize("name", METRICS)
def test_metric_loads_by_name(name):
    assert callable(harness.load_module("metrics", name).read)


def small(name, rows=600, lengths=None):
    """The cell at a size the CPU serves in about a second a batch."""
    cell = harness.Cell.load(name, SPEC)
    params = dict(cell.mix["params"])
    params["lengths"] = lengths or sorted(set(params["lengths"]))[:3]
    params["fixed"] = [q for q in params.get("fixed", [])
                       if len(q) in params["lengths"]][:1]
    return harness.Cell.load(name, SPEC, overrides={
        "config": {"params": {**cell.config["params"],
                              "num_samples": rows}},
        "mix": {"params": params, "batches": 3}})


@pytest.mark.parametrize("name", CELLS)
def test_traffic_repeats_for_a_seed(name):
    """A seed deals the mix's fixed queries into its batches: the same
    seed the same batches; another seed the same queries and the same
    shape groups in every batch, dealt otherwise."""
    cell = harness.Cell.load(name, SPEC)
    gen = harness.load_module("corpora", cell.config["generator"])
    a, sa = harness.traffic(cell, gen, 2**31 + 5)
    b, _ = harness.traffic(cell, gen, 2**31 + 5)
    c, sc = harness.traffic(cell, gen, 2**31 + 6)
    assert a == b and a != c and sa == sc
    assert len(a) == cell.mix["batches"]
    assert sorted(q for batch in a for q in batch) == sorted(
        q for batch in c for q in batch)
    assert all(len(batch) == 32 for batch in a)
    shapes = [sorted(sa[q] for q in batch) for batch in a + c]
    assert all(s == shapes[0] for s in shapes)


@pytest.mark.parametrize("name", CELLS)
def test_generator_repeats_for_a_seed(name):
    cell = harness.Cell.load(name, SPEC)
    gen = harness.load_module("corpora", cell.config["generator"])
    rows = gen.generate(**{**cell.config["params"], "num_samples": 3000},
                        seed=4)
    tgen = harness.load_module("traffic", cell.mix["generator"])

    def draw(seed):
        return tgen.generate(rows, cell.mix["params"], 4,
                             np.random.default_rng(seed))

    assert draw(7) == draw(7) and draw(7)[0] != draw(8)[0]


def synthetic_run():
    """Two batches in a 100 ms window: kernels 10 + 5 ms, other work 20
    ms, dispatches of 6 and 4 ms; the card idles while the host
    dispatches."""
    ms = 1_000_000
    trace = Trace(
        device=[("void colstream_fuzzy_kernel<4, false>(Args)", 10 * ms,
                 20 * ms),
                ("void row_gather_kernel(int4 const*)", 20 * ms, 25 * ms),
                ("void at::native::sort_kernel", 50 * ms, 70 * ms)],
        spans=[("window", 0, 100 * ms), ("dispatch", 0, 6 * ms),
               ("dispatch", 30 * ms, 34 * ms), ("result", 34 * ms, 48 * ms),
               ("traffic", 72 * ms, 80 * ms)])
    cell = harness.Cell.load(CELLS[0], SPEC)
    run = harness.Run(cell, n_rows=1000,
                      batches=[["a", "b"], ["c", "d"]], window_s=0.1,
                      served=[(0, 0.0, 0.004, 0.030), (1, 0.03, 0.004,
                                                       0.045)],
                      peak_bytes=3 * 2**20, trace=trace, setup_s=12.5)
    return run


@pytest.mark.parametrize("name,value", [
    ("haystacks_per_s", 4 * 1000 / 0.1),
    ("peak_device_mib", 3.0),
    ("setup_s", 12.5),
    ("request_p95_ms.host", 30 + 0.95 * 15),
    ("host_dispatch_ms", 5.0),
    ("kernel_device_ms", 15 / 2),
    ("batch_ops_device_ms", 20 / 2),
    ("device_idle_share", 1 - 35 / 100),
])
def test_metric_reads_known_value(name, value):
    got = harness.load_module("metrics", name).read(synthetic_run())
    assert got == pytest.approx(value)


def test_breakdown_of_synthetic_trace():
    bd = harness.breakdown(synthetic_run().trace)
    ops = dict(bd["device_ops"])
    assert ops["void at::native::sort_kernel"] == pytest.approx(0.020)
    idle = dict(bd["idle_gaps"])
    # gaps: 0-10 (dispatch), 25-50 (midpoint 37.5 in result), 70-100
    # (midpoint 85: no span)
    assert idle["dispatch"] == pytest.approx(0.010)
    assert idle["result"] == pytest.approx(0.025)
    assert idle["loop"] == pytest.approx(0.030)


def test_no_card_no_result(tmp_path):
    """run.py on this card-less machine exits non-zero and prints no
    result line."""
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "frizbee_tpu"])
def test_banned_module_before_result_line_no_result(monkeypatch, capsys,
                                                    name):
    """A banned module loaded after the window (by the reference, the
    roofline or a metric reader) still stops the result line."""
    import importlib
    import types

    import torch

    run = importlib.import_module("portbench.run")

    def fake_run_cell(*args, **kwargs):
        sys.modules[name + ".core"] = types.ModuleType(name + ".core")
        return {"correct": True, "checks": {}}, {"answers_checked": 1,
                                                  "phases_s": {}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(harness, "run_cell", fake_run_cell)
    monkeypatch.delitem(sys.modules, name + ".core", raising=False)
    try:
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
    finally:
        sys.modules.pop(name + ".core", None)
    out = capsys.readouterr()
    assert rc != 0
    assert not out.out.strip()
    assert name in out.err


def test_banned_names_compared_whole():
    """The port's own top-level name passes: names compare whole."""
    assert harness.banned_modules(
        ["frizbee_tpu_torch.ops.batch", "numpy", "jaxlib.xla_client",
         "frizbee_tpu.ops", "flaxen"]) == ["frizbee_tpu", "jaxlib"]


@pytest.fixture(scope="module")
def small_runs():
    """One small run of the fuzzy cell as it is and with each fault in
    its timed path (the card's check skipped: the CPU serves)."""
    cell = small(CELLS[0])
    return {fault: harness.run_cell(cell, 2**31 + 9, 2.5, fault == "trace",
                                    device="cpu",
                                    fault=None if fault in ("sound", "trace")
                                    else fault)
            for fault in ("sound", "trace", *check.FAULTS)}


def test_result_line_keys(small_runs):
    for name in ("sound", "trace"):
        out, notes = small_runs[name]
        keys = list(out)
        want = ["correct", "attempted", "failed", "metrics", "device"]
        if name == "trace":
            want.append("breakdown")
        assert keys == want + ["checks"]
        json.dumps(out)
        assert out["correct"] and notes["answers_checked"] > 0


@pytest.mark.parametrize("fault", list(check.FAULTS))
def test_fault_is_not_correct(small_runs, fault):
    out, _ = small_runs[fault]
    assert out["correct"] is False


def test_control_is_not_correct():
    """The reference, ties reversed, in the program's place."""
    cell = small(CELLS[0], rows=1500, lengths=[3, 4])
    got = control.readings(cell, 11, 2.0, device="cpu")
    assert got["program"]["wrong_answers"] == 0
    assert got["control"]["wrong_answers"] > 0
    for fault in check.FAULTS:
        f = got[fault]
        assert f["wrong_answers"] + f["missing_answers"] > 0
