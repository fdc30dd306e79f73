"""The colstream bisect probe of the port (``frizbee_tpu_torch/probes/
colstream_bisect.py``, the plain versions that the CUDA stage kernels of
``csrc/probe_colstream_bisect.cu`` are held to on the card) against the
reference probes ``benchmarks/probe_colstream_bisect.py`` and
``probe_colstream_bisect2.py``.

The reference scripts are imported by path, which runs their module-level
data code (numpy draws and jnp arrays, no file); each stage runs in a
``pallas_call`` built as the scripts' ``run`` builds it, in interpret mode.
Zero tolerance: the port's data builders equal the scripts' arrays, and
each of the ten stage plain versions writes the reference stage's five
planes exactly."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from frizbee_tpu_torch.probes import colstream_bisect as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _load(name):
    path = os.path.join(ROOT, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def refs():
    return _load("probe_colstream_bisect"), _load("probe_colstream_bisect2")


@pytest.fixture(scope="module")
def port_inputs():
    return tb.to_colstream(*tb.bisect_inputs(), CPU)


def _run_interpret(mod, kernel, arrays=None):
    """The reference script's ``run``, in interpret mode, on its arrays or
    on ``arrays`` = (scal, cpT, nuT) of the same shapes."""
    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(mod.nG,),
            in_specs=[
                pl.BlockSpec((mod.W, mod.SUBL, 128), lambda i, *_: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((mod.SUBL, 128), lambda i, *_: (i, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=[pl.BlockSpec((mod.SUBL, 128), lambda i, *_: (i, 0))
                       for _ in range(5)],
        ),
        out_shape=[jax.ShapeDtypeStruct((mod.nG * mod.SUBL, 128), jnp.int32)
                   for _ in range(5)],
        interpret=True,
    )(*(arrays or (mod.scal, mod.cpT, mod.nuT)))
    return np.stack([np.asarray(o) for o in out])


def test_inputs_match_reference(refs, port_inputs):
    """The port's data builders against the scripts' module-level cp, nu,
    needle, cpT, nuT and scal."""
    cp, nu, needle = tb.bisect_inputs()
    cpT, nuT, scal = port_inputs
    for ref in refs:
        assert (ref.W, ref.n, ref.SUBL, ref.B) == (tb.W, tb.N, tb.SUBL,
                                                   2 * tb.GROUP_ROWS)
        np.testing.assert_array_equal(cp, ref.cp)
        np.testing.assert_array_equal(nu, ref.nu)
        np.testing.assert_array_equal(needle, ref.needle)
        np.testing.assert_array_equal(cpT.numpy(), np.asarray(ref.cpT))
        np.testing.assert_array_equal(nuT.numpy(), np.asarray(ref.nuT))
        np.testing.assert_array_equal(scal.numpy(), np.asarray(ref.scal))


def _reference_kernel(refs, stage):
    bisect, bisect2 = refs
    if stage in ("fstart_only_outz", "tail_only_outz", "both_outz",
                 "none_outcarries", "both_outcarries"):
        _adv, fstart, tail, carries = tb.PF_STAGES[stage]
        return bisect2, bisect2.make_stage(fstart, tail, carries)
    fn = {"a_simple+outs": "stage_a", "b_full_sw": "stage_b",
          "c_pf_t0": "stage_c", "c1_no_advance": "stage_c1",
          "c2_only_advance": "stage_c2"}[stage]
    return bisect, getattr(bisect, fn)


@pytest.mark.parametrize("stage", tb.STAGES)
def test_stage_plain_against_reference(refs, port_inputs, stage):
    """Each stage's plain version writes the reference stage's five planes
    (interpret mode) bit for bit, and the wrapper on a CPU tensor is the
    plain version."""
    mod, kernel = _reference_kernel(refs, stage)
    want = _run_interpret(mod, kernel)
    cpT, nuT, scal = port_inputs
    got = tb.bisect_stage_plain(stage, cpT, nuT, scal, W=tb.W, n=tb.N)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tb.bisect_stage(stage, cpT, nuT, scal, W=tb.W,
                                       n=tb.N), got)


def test_stages_exercise_their_branches(port_inputs):
    """The inputs reach what each stage tracks: the SW pass scores and
    finds exact rows, the prefilter passes and the carries are non-zero,
    and the stages that differ in the reference differ here."""
    cpT, nuT, scal = port_inputs
    out = {s: tb.bisect_stage_plain(s, cpT, nuT, scal, W=tb.W, n=tb.N)
           for s in tb.STAGES}
    b = out["b_full_sw"]
    assert (b[1] > 0).any() and (b[3] > 0).any()
    for s in ("c_pf_t0", "c1_no_advance", "both_outcarries"):
        assert (out[s][0] > 0).any() and (out[s][3] > 0).any(), s
    assert not torch.equal(out["c_pf_t0"], out["c1_no_advance"])
    assert not torch.equal(out["both_outz"], out["both_outcarries"])
    assert not (out["c2_only_advance"][2:] != 0).any()


def test_exact_rows_against_reference(refs):
    """The reference's inputs hold no row equal to the needle, so stage B's
    exact flag is 0 throughout; here some rows are: the needle over the
    row's 8 units, other units stored past them (exact: the test reads
    only the first n units), the needle with an upper-case unit (a match,
    not exact), and the needle one unit short (not exact). Each stage
    against the reference's, B's exact plane non-zero."""
    cp, nu, needle = tb.bisect_inputs()
    cp[5, :8], nu[5] = needle, 8
    cp[7, :8], nu[7] = needle, 8
    cp[7, 3] -= 32
    cp[8, :8], nu[8] = needle, 7
    cpT, nuT, scal = tb.to_colstream(cp, nu, needle, CPU)
    arrays = tuple(jnp.asarray(t.numpy()) for t in (scal, cpT, nuT))
    for stage in ("b_full_sw", "c_pf_t0", "c2_only_advance"):
        mod, kernel = _reference_kernel(refs, stage)
        want = _run_interpret(mod, kernel, arrays)
        got = tb.bisect_stage_plain(stage, cpT, nuT, scal, W=tb.W, n=tb.N)
        np.testing.assert_array_equal(got.numpy(), want)
        if stage == "b_full_sw":
            exact = want[2].reshape(-1)
            assert exact[5] == 1, exact[5:9]
            assert exact[7] == 0 and exact[8] == 0, exact[5:9]


def test_full_stage_against_reference(refs, port_inputs):
    """Stage "full": the port's ``match_units_colstream`` on the bisect
    inputs (byte units) against the reference's, interpret mode."""
    bisect, _ = refs
    want = bisect.colstream.match_units_colstream(
        bisect.cpT, bisect.nuT, bisect.scal, W=bisect.W, n=bisect.n,
        max_typos=0, scoring=tb.FULL_SCORING, unicode=False,
        no_prefilter=False, interpret=True)
    a, kw = tb.full_args(*port_inputs)
    got = tb.match_units_colstream(*a, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_wrapper_refuses_bad_arguments(port_inputs):
    cpT, nuT, scal = port_inputs
    with pytest.raises(ValueError, match="unknown stage"):
        tb.bisect_stage("d", cpT, nuT, scal, W=tb.W, n=tb.N)
    with pytest.raises(ValueError, match="1-16"):
        tb.bisect_stage("c_pf_t0", cpT, nuT, scal, W=tb.W, n=17)


def test_probe_main_on_cpu(capsys):
    """The probe's entry point on the CPU: every stage in the reference
    scripts' order, each ok, exit code 0; ``--rows`` adds rows and a null
    time to each line."""
    assert tb.main(["--device", "cpu", "--rows", "2048"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    stages = [x["stage"] for x in lines]
    assert stages == list(tb.REFERENCE_ORDER) * 2
    assert all(x["ok"] for x in lines)
    assert all(x["rows"] == 2048 and x["ms"] is None for x in lines[11:])


def test_failed_check_ends_the_run(capsys):
    """A record whose check is false ends the probe with exit code 1: the
    records after it are neither consumed nor printed."""
    from frizbee_tpu_torch.probes import emit

    seen = []

    def records():
        for rec in ({"stage": "a", "ok": True}, {"stage": "b", "ok": False},
                    {"stage": "c", "ok": True}):
            seen.append(rec["stage"])
            yield rec
    assert emit(records()) == 1
    assert seen == ["a", "b"]
    assert len(capsys.readouterr().out.splitlines()) == 2
    assert emit(iter([{"R": 64, "exact_equal": False}])) == 1
    assert emit(iter([{"correct": True, "mismatches": 0}])) == 0
