"""The port's profiling helpers (``frizbee_tpu_torch/profiling.py``) on
the CPU: ``trace`` writes one Chrome trace holding an ``annotate`` span,
``wall_time`` is the median of ``iters`` blocking calls after one
warm-up, and the module imports no JAX and nothing of ``frizbee_tpu``
(a fresh process)."""

import json
import os
import subprocess
import sys

import torch

from frizbee_tpu_torch import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_one_chrome_trace(tmp_path, capsys):
    with profiling.trace("probe", log_dir=str(tmp_path)) as prof:
        with profiling.annotate("frizbee_span"):
            torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path)
    assert len(files) == 1
    assert files[0].startswith("probe-") and files[0].endswith(".json")
    with open(tmp_path / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "frizbee_span" for e in events)
    assert any(e.key == "frizbee_span" for e in prof.key_averages())
    assert str(tmp_path / files[0]) in capsys.readouterr().out


def test_trace_default_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("FRIZBEE_TPU_TRACE_DIR", str(tmp_path / "traces"))
    with profiling.trace():
        torch.zeros(4).add_(1)
    (name,) = os.listdir(tmp_path / "traces")
    assert name.startswith("frizbee-")


def test_device_time_median_of_blocking_calls():
    calls = []

    def fn(x, scale=1):
        calls.append(scale)
        return (x * scale, [x + 1], {"y": x})

    t = profiling.wall_time(fn, torch.arange(8), iters=5, scale=3)
    assert len(calls) == 6 and set(calls) == {3}
    assert t > 0
    assert profiling.wall_time(lambda: None, iters=1) > 0


def test_profiling_imports_no_jax():
    code = ("import sys; import frizbee_tpu_torch.profiling; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'frizbee_tpu')]; "
            "assert not bad, bad; print('OK')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
