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
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from frizbee_tpu_torch.ops.kernels import (
    is_delim,
    is_lower,
    is_upper,
    pack_needle_scalars,
)
from frizbee_tpu_torch.probes import colstream_bisect as tb
from frizbee_tpu_torch.probes.transposed import ring_rows

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


def _colstream(cp, nu, needle, flip):
    B, W = cp.shape
    cpT = (torch.from_numpy(cp).reshape(B // tb.GROUP_ROWS, tb.SUBL, 128, W)
           .permute(0, 3, 1, 2).reshape(-1, tb.SUBL, 128).contiguous())
    scal = pack_needle_scalars(
        torch.from_numpy(np.concatenate([needle, flip])), B)
    return cpT, torch.from_numpy(nu).reshape(-1, 128), scal


def _bonus_rows(n=16, W=64, seed=3):
    """Rows that take every bonus at n = 16: a needle of lower-to-upper
    case steps and delimiters; row 0 the needle itself (a prefix hit,
    exact case, nu = n), row 1 the needle repeated over W columns, row 2
    its flipped case, the rest random units of the needle's, its flip's
    and delimiters."""
    needle = np.frombuffer(b"aBcD-eF_gHiJ.kLm", np.uint8).astype(np.int32)
    assert len(needle) == n
    flip = np.where((needle >= 97) & (needle <= 122), needle - 32,
                    np.where((needle >= 65) & (needle <= 90), needle + 32,
                             needle)).astype(np.int32)
    rng = np.random.default_rng(seed)
    pool = np.concatenate([needle, flip, np.frombuffer(b"-_. /", np.uint8)])
    cp = rng.choice(pool, (tb.GROUP_ROWS, W)).astype(np.int32)
    nu = rng.integers(0, W + 1, tb.GROUP_ROWS).astype(np.int32)
    cp[0, :n], nu[0] = needle, n
    cp[1], nu[1] = np.resize(needle, W), W
    cp[2, :n], nu[2] = flip, n
    return cp, nu, needle, flip


def test_stage_b_int16_range():
    """The kernel's stage B runs two rows in s16x2 halves and relies on
    every cell staying within 36 n (12 a hit, up to 12 of bonus, 4 for an
    exact one). On rows built to take every bonus (lower-to-upper steps,
    delimiters, a prefix hit, exact case) at n = 16, every plane stays
    well inside int16 and the score within 36 n; the exact row is exact
    and outscores the needle's hits alone (its bonuses counted)."""
    n, W = 16, 64
    cp, nu, needle, flip = _bonus_rows(n, W)
    cpT, nuT, scal = _colstream(cp, nu, needle, flip)
    got = tb.bisect_stage_plain("b_full_sw", cpT, nuT, scal, W=W, n=n)
    planes = got.reshape(5, -1)
    assert int(planes.abs().max()) < 32767
    assert int(planes[1].max()) <= 36 * n
    assert int(planes[2, 0]) == 1 and int(planes[1, 0]) > 12 * n + 12


def _bonus_class(prev, unit):
    """The kernel's bonus class (bonus / 4) of a unit after prev (-1 before
    column 0): 3 on the first column, else one each for a capitalisation
    and a delimiter step."""
    t = torch.tensor([prev, unit])
    up, low, de = is_upper(t), is_lower(t), is_delim(t)
    if prev < 0:
        return 3
    return int(bool(up[1] and low[0])) + int(bool(de[0] and not de[1]))


BIAS = 64  # csrc/column_ring.cuh kBias: each 16-bit half holds a value + 64


def _ring_stage_b(cp, nu, orig, flip):
    """Stage B as the kernel computes it, in a row-at-a-time model: each
    unit's operands from its bonus class's table entries (the diagonal
    operand + 6: 18 + 4 class on a hit of either case, 4 more on an exact
    one, 0 else; the gap cost + 5: 0 after a hit, 4 else), then, each
    value + BIAS, t = max(diag_in + d - 6, h + l_k - 5, BIAS) and cur =
    max(up_src + g_{k-1} - 5, t), l_k the previous column's g_k; every
    value formed stays inside an unsigned 16-bit half. Returns the five
    planes."""
    B, W = cp.shape
    n = len(orig)
    out = np.zeros((5, B), np.int64)
    for r in range(B):
        h, l = [BIAS] * n, [4] * n
        best = end = neq = 0
        for j in range(W):
            u, valid = int(cp[r, j]), j < nu[r]
            cls = _bonus_class(int(cp[r, j - 1]) if j else -1, u)
            ex = [valid and u == o for o in orig]
            occ = [e or (valid and u == f) for e, f in zip(ex, flip)]
            d = [18 + 4 * cls + 4 * e if o else 0 for e, o in zip(ex, occ)]
            g = [0 if o else 4 for o in occ]
            if j < n:
                neq |= u != orig[j]
            diag_in, up_src, g_up = BIAS, 0, 0
            for k in range(n):
                terms = [diag_in + d[k] - 6, h[k] + l[k] - 5]
                if k:
                    terms.append(up_src + g_up - 5)
                assert 0 <= min(terms) and max(terms) < 1 << 16
                cur = max(*terms, BIAS)
                diag_in, h[k], l[k], up_src, g_up = h[k], cur, g[k], cur, g[k]
            if valid and h[-1] - BIAS > best:
                best, end = h[-1] - BIAS, j
        out[:, r] = [1, best, int(nu[r] == n and neq == 0),
                     end if best > 0 else 0, 0]
    return out


def test_ring_stage_b_model():
    """The kernel's rewritten stage-B cell and bonus classes (table
    operands, no compare, packed adds and 3-input max) against the plain
    version on the
    bonus rows' first 96 rows."""
    n, W = 16, 24
    cp, nu, needle, flip = _bonus_rows(n, W)
    nu = np.minimum(nu, W)
    cpT, nuT, scal = _colstream(cp, nu, needle, flip)
    want = tb.bisect_stage_plain("b_full_sw", cpT, nuT, scal, W=W, n=n)
    got = _ring_stage_b(cp[:96], nu[:96], needle.tolist(), flip.tolist())
    np.testing.assert_array_equal(got, want.reshape(5, -1)[:, :96].numpy())


def _source_constants(name):
    path = os.path.join(ROOT, "frizbee_tpu_torch", "csrc", name)
    with open(path) as fh:
        text = fh.read()
    return dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))


def test_ring_geometry_mirrors_source():
    """``ring_geometry``'s constants are the kernel source's."""
    src = _source_constants("probe_colstream_bisect.cu")
    assert int(src["kThreads"]) == tb.RING_THREADS
    assert src["kTileRows"].startswith("2 * kThreads")
    assert tb.RING_TILE_ROWS == 2 * tb.RING_THREADS
    assert int(src["kChunkCols"]) == tb.RING_CHUNK_COLS
    assert int(src["kRingStages"]) == tb.RING_STAGES
    assert int(src["kMinBlocks"]) == tb.RING_MIN_BLOCKS
    assert int(src["kPrefilterChunkCols"]) == tb.RING_PREFILTER_CHUNK_COLS
    assert int(src["kPrefilterMinBlocks"]) == tb.RING_PREFILTER_MIN_BLOCKS
    assert int(src["kBonusClasses"]) == tb.BONUS_CLASSES
    assert int(src["kClassBytes"]) == tb.CLASS_BYTES
    assert int(src["kClassPairBytes"]) == tb.CLASS_PAIR_BYTES


@pytest.mark.parametrize("groups", [2, 1024])
def test_ring_geometry(groups):
    """At the reference's 2048 rows and the 1M-row timing shape: every row
    is walked by exactly one thread half, a block's shared memory fits the
    card's 227 KB for every stage and n, and 1M rows fill the 132 SMs."""
    geo = tb.ring_geometry(groups, tb.W, tb.N, "b_full_sw")
    rows = ring_rows(geo["blocks"], tb.RING_TILE_ROWS, tb.RING_THREADS)
    assert np.array_equal(np.sort(rows.reshape(-1)),
                          np.arange(groups * tb.GROUP_ROWS))
    for stage in tb.STAGES:
        for n in range(1, 17):
            assert tb.ring_geometry(groups, tb.W, n, stage)["smem"] <= (
                227 * 1024)
    if groups == 1024:
        assert geo["blocks"] >= 132
