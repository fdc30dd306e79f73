"""``chip_smoke._Watchdog``, the stack-dumping watchdog over the smoke
run's phases and side processes, on the CPU: a phase still running at
WATCH_SHARE of its budget has every thread's stack and its tasks' states
printed and goes on; a phase past its budget has them printed again, the
failure callback run and the process ended with exit code 1; a side process
that stalls while it is joined has its log echoed and is killed. Each case
runs in a fresh process, since the watchdog ends the process it watches."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(body, timeout=60, on_fail="lambda: print('on_fail', flush=True)"):
    code = ("import time, chip_smoke as c\n"
            f"w = c._Watchdog(on_fail={on_fail})\n"
            + body)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def _sleeping_phase(seconds):
    return f"def slow_phase():\n    time.sleep({seconds})\n"


def test_watchdog_dumps_at_share_and_lets_the_phase_finish():
    r = _run(_sleeping_phase(2.5)
             + "with w.watch('phase demo', 4):\n    slow_phase()\n"
             + "w.close()\nprint('finished', flush=True)\n")
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "watchdog: phase demo still running at" in out
    assert "of its budget of 4 s" in out
    # the main thread's stack, caught inside the phase
    assert "in slow_phase" in out
    assert "watchdog: tasks of process" in out
    assert "overran" not in out and "on_fail" not in out
    assert out.rstrip().endswith("finished")


@pytest.mark.parametrize("budget", [2, 3])
def test_watchdog_ends_the_run_past_the_budget(budget):
    r = _run(_sleeping_phase(30)
             + f"with w.watch('phase stuck', {budget}):\n    slow_phase()\n"
             + "print('finished', flush=True)\n")
    assert r.returncode == 1
    out = r.stdout
    assert f"watchdog: phase stuck overran its budget of {budget} s" in out
    assert out.count("in slow_phase") == 2  # at the share and at the end
    assert "on_fail" in out and "finished" not in out
    assert f"past its budget of {budget} s" in r.stderr


def test_watchdog_drops_a_side_once_it_ends():
    r = _run("import subprocess, sys\n"
             "p = subprocess.Popen([sys.executable, '-c', 'pass'])\n"
             "w.add('side process demo', 2, alive=lambda: p.poll() is None,"
             " pid=p.pid)\n"
             "p.wait()\ntime.sleep(3)\nw.close()\n"
             "print('finished', flush=True)\n")
    assert r.returncode == 0, r.stderr
    assert "side process demo" not in r.stdout
    assert r.stdout.rstrip().endswith("finished")


# a side process that prints its pid and then sleeps past every budget
_SLEEPING_SIDE = ("import os, time; print('side log: pid', os.getpid(), "
                  "flush=True); time.sleep(60)")


@pytest.mark.parametrize("deadline", ["phase", "side"])
def test_watchdog_echoes_and_kills_a_side_stalled_in_its_join(deadline):
    # the phase that joins the side has the shorter budget, or the side's
    # own SIDE_TIMEOUT runs out first
    phase_budget, side_budget = (3, 900) if deadline == "phase" else (900, 3)
    r = _run("import tempfile\n"
             f"c.SIDE_TIMEOUT = {side_budget}\n"
             f"c._Side.CODE = {_SLEEPING_SIDE!r}\n"
             "sides = c._Sides()\n"
             "sides['slow'] = c._Side('slow', tempfile.mkdtemp(), w)\n"
             f"with w.watch('phase wait', {phase_budget}):\n"
             "    sides.join('slow')\n"
             "print('finished', flush=True)\n",
             on_fail="lambda: sides.stop(echo=True)")
    assert r.returncode == 1
    out = r.stdout
    label = "phase wait" if deadline == "phase" else "side process slow"
    assert f"watchdog: {label} overran its budget of 3 s" in out
    # the main thread's stack, caught inside the join
    assert "in join" in out
    # the side's log, echoed by on_fail, and the side killed
    lines = [l for l in out.splitlines() if l.startswith("side log: pid")]
    assert len(lines) == 1, out
    pid = int(lines[0].split()[-1])
    assert f"process {pid}:" in out  # its tasks, listed at the dumps
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert "finished" not in out
    assert f"past its budget of 3 s" in r.stderr
