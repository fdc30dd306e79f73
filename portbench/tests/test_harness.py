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


def with_held_out(spec):
    """``spec`` with the cells of ``held_out.json`` added as that file
    says to add them."""
    held = harness.load_json(harness.HERE, "held_out.json")
    out = {**spec, "workloads": spec["workloads"] + held["workloads"],
           "per_layer": []}
    for m in spec["per_layer"]:
        extra = held["extend_workloads"].get(m["name"], [])
        out["per_layer"].append(
            {**m, "workloads": m["workloads"] + extra} if extra else m)
    out["per_layer"] += held["per_layer"]
    return out


FULL_SPEC = with_held_out(SPEC)
MESH_CELL = next(w["name"] for w in FULL_SPEC["workloads"] if w["chips"] > 1)
METRICS = [m["name"] for m in
           FULL_SPEC["end_to_end"] + FULL_SPEC["per_layer"]]


def test_held_out_cells_keep_to_the_spec():
    """The held-out entries name a configuration, a traffic mix and
    metrics that exist, and none of them is in BENCHMARK.json already."""
    names = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    metrics = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for w in FULL_SPEC["workloads"][len(CELLS):]:
        assert w["name"] not in names and w["config"] in configs
        assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                           w["traffic"] + ".json"))
    for m in FULL_SPEC["per_layer"][len(SPEC["per_layer"]):]:
        assert m["name"] not in metrics
        assert m["workloads"] and m["moves"] in metrics
    held = harness.load_json(harness.HERE, "held_out.json")
    assert set(held["extend_workloads"]) <= metrics


@pytest.mark.parametrize("name", CELLS + [MESH_CELL])
def test_cell_loads_by_name(name):
    cell = harness.Cell.load(name, FULL_SPEC)
    harness.load_module("corpora", cell.config["generator"])
    harness.load_module("traffic", cell.mix["generator"])
    assert cell.metrics(False) and cell.metrics(True)
    assert any(m["name"] == "setup_s" for m in cell.metrics(False))


@pytest.mark.parametrize("name", METRICS)
def test_metric_loads_by_name(name):
    assert callable(harness.load_module("metrics", name).read)


def small(name, rows=600, lengths=None):
    """The cell at a size the CPU serves in about a second a batch."""
    cell = harness.Cell.load(name, FULL_SPEC)
    params = dict(cell.mix["params"])
    params["lengths"] = lengths or sorted(set(params["lengths"]))[:3]
    params["fixed"] = [q for q in params.get("fixed", [])
                       if len(q) in params["lengths"]][:1]
    return harness.Cell.load(name, FULL_SPEC, overrides={
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


def synthetic_mesh_run():
    """Two batches in a 100 ms window of the four-card cell, cards 2 and 3
    idle: card 0 a hand kernel 10-20 ms, a sort 20-40 and a copy to
    another card 40-42; card 1 a copy from the host 0-1, a hand kernel
    5-25 and a copy to another card 45-48."""
    ms = 1_000_000
    peer = "Memcpy PtoP (Device -> Device)"
    trace = Trace(
        device=[("void colstream_fuzzy_kernel<4, false>(Args)", 10 * ms,
                 20 * ms),
                ("void at::native::sort_kernel", 20 * ms, 40 * ms),
                (peer, 40 * ms, 42 * ms),
                ("Memcpy HtoD (Pageable -> Device)", 0, 1 * ms),
                ("void match_units_kernel<16, 0, false, true>(Args)",
                 5 * ms, 25 * ms),
                (peer, 45 * ms, 48 * ms)],
        spans=[("window", 0, 100 * ms), ("dispatch", 0, 50 * ms),
               ("dispatch", 50 * ms, 90 * ms)],
        cards=[0, 0, 0, 1, 1, 1])
    cell = harness.Cell.load(MESH_CELL, FULL_SPEC)
    return harness.Run(cell, n_rows=1000, batches=[["a", "b"], ["c", "d"]],
                       window_s=0.1, served=[(0, 0.0, 0.05, 0.05),
                                             (1, 0.05, 0.04, 0.04)],
                       peak_bytes=3 * 2**20,
                       card_peaks=[3 * 2**20, 2**20, 2**20, 2**20],
                       trace=trace, setup_s=12.5)


@pytest.mark.parametrize("name,value", [
    # the cards' idle shares 0.68, 0.76, 1, 1
    ("device_idle_share.mesh", (0.68 + 0.76 + 1 + 1) / 4),
    ("merge_copy_ms", (2 + 3) / 2),
    ("kernel_device_ms.mesh", (10 + 20) / 2),
    # 11.2 ms of least time over the cards' 32 + 24 busy ms
    ("match_roofline.mesh", 100 * 11.2 / 56),
])
def test_mesh_metric_reads_known_value(monkeypatch, name, value):
    from portbench import roofline

    monkeypatch.setattr(roofline, "served_least_s", lambda run: 0.0112)
    got = harness.load_module("metrics", name).read(synthetic_mesh_run())
    assert got == pytest.approx(value)


def test_mesh_device_info():
    """Four cards counted, the fullest card's peak, busy seconds averaged
    over the cards; the one-card view of the same trace merges them."""
    run = synthetic_mesh_run()
    info = harness.device_info(run, "cpu")
    assert info["count"] == 4
    assert info["memory_peak_bytes"] == 3 * 2**20
    assert info["card_peak_bytes"] == run.card_peaks
    assert info["card_busy_s"] == pytest.approx([0.032, 0.024, 0, 0])
    assert info["busy_s"] == pytest.approx(0.056 / 4)
    assert info["window_s"] == pytest.approx(0.1)
    assert run.trace.busy_s() == pytest.approx(0.041)


def test_one_card_device_info():
    info = harness.device_info(synthetic_run(), "cpu")
    assert info["count"] == 1 and "card_busy_s" not in info
    assert info["busy_s"] == pytest.approx(0.035)


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
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *device: None)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
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


@pytest.fixture(scope="module")
def small_mesh_runs():
    """The four-card cell, small, on four shards of the CPU: as it is,
    traced, and with each fault in its timed path."""
    cell = small(MESH_CELL)
    return {fault: harness.run_cell(cell, 2**31 + 13, 2.5, fault == "trace",
                                    device="cpu",
                                    fault=None if fault in ("sound", "trace")
                                    else fault)
            for fault in ("sound", "trace", *check.FAULTS)}


def test_mesh_result_line(small_mesh_runs):
    """The mesh session serves through match_topk_batch_sharded on four
    shards, one batch at a time, and is correct."""
    for name in ("sound", "trace"):
        out, notes = small_mesh_runs[name]
        want = ["correct", "attempted", "failed", "metrics", "device"]
        if name == "trace":
            want.append("breakdown")
        assert list(out) == want + ["checks"]
        json.dumps(out)
        assert out["correct"] and notes["answers_checked"] > 0
        assert out["device"]["count"] == 4 and out["failed"] == 0
        assert set(out["metrics"]) <= {
            m["name"] for m in harness.Cell.load(MESH_CELL, FULL_SPEC).metrics(
                name == "trace")}
    assert "haystacks_per_s" in small_mesh_runs["sound"][0]["metrics"]
    assert len(small_mesh_runs["trace"][0]["device"]["card_busy_s"]) == 4


def test_mesh_session_serves_sharded(monkeypatch):
    """Every batch of the mesh session goes through the sharded entry
    point, on a mesh of as many shards as the cell has chips."""
    import frizbee_tpu_torch

    calls = []
    sharded = frizbee_tpu_torch.match_topk_batch_sharded

    def counting(queries, corpus, mesh, config, k):
        calls.append(mesh.size)
        return sharded(queries, corpus, mesh, config, k)

    monkeypatch.setattr(frizbee_tpu_torch, "match_topk_batch_sharded",
                        counting)
    monkeypatch.setattr(frizbee_tpu_torch, "match_topk_batch_async", None)
    session = harness.Session(small(MESH_CELL, rows=300), 3, device="cpu")
    assert session.depth == 1
    _w, served, failed = session.serve(0.0, max_batches=2)
    assert calls == [4] * (len(session.batches) + 2)
    assert len(served) == 2 and failed == 0
    session.release()
    assert session.corpus is None and session.mesh is None


@pytest.mark.parametrize("fault", list(check.FAULTS))
def test_mesh_fault_is_not_correct(small_mesh_runs, fault):
    out, _ = small_mesh_runs[fault]
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


def test_mesh_control_is_not_correct():
    """The control and the faults on the four-shard mesh session."""
    cell = small(MESH_CELL, rows=1500, lengths=[3, 4])
    got = control.readings(cell, 17, 2.0, device="cpu")
    assert got["program"]["wrong_answers"] == 0
    assert got["program"]["missing_answers"] == 0
    assert got["control"]["wrong_answers"] > 0
    for fault in check.FAULTS:
        f = got[fault]
        assert f["wrong_answers"] + f["missing_answers"] > 0
