"""The broad top-k probe of the port (``frizbee_tpu_torch/probes/
broad_topk.py``: the serving path's ``ops/batch._broad_topk`` at R = 64
and 128, over the row gather) against the reference probe
``benchmarks/probe_broad_topk.py``'s ``tournament_topk`` (its narrow-tile
``row_gather`` ``pallas_call`` in interpret mode) and ``np.sort``.

The reference script is imported by path. Keys come from the port's copy
of the reference's key builder, at (2, 8192): ~35% matched rows, the rest
the int64 sentinel; then a sentinel-heavy set and fetch == the number of
blocks. Zero tolerance."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frizbee_tpu_torch.ops.batch import _broad_topk
from frizbee_tpu_torch.probes import broad_topk as tbk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    path = os.path.join(ROOT, "benchmarks", "probe_broad_topk.py")
    spec = importlib.util.spec_from_file_location("reference_broad_topk",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(ref, keys, fetch, R):
    with jax.enable_x64(True):
        return np.asarray(ref.tournament_topk(jnp.asarray(keys), fetch, R,
                                              interpret=True))


def _keys(matched_share, seed=0, q=2, t=8192):
    rng = np.random.default_rng(seed)
    keys = tbk.make_keys(rng, q, t)
    if matched_share < 0.35:
        drop = rng.random((q, t)) >= matched_share / 0.35
        keys = np.where(drop, tbk.SENT, keys)
    return keys


@pytest.mark.parametrize("case,R,fetch", [
    ("reference", 64, 64), ("reference", 128, 64),
    ("sentinel_heavy", 64, 64), ("sentinel_heavy", 128, 64),
    ("fetch_is_blocks", 64, 128), ("fetch_is_blocks", 128, 64),
])
def test_tournament_against_reference(ref, case, R, fetch):
    """``_broad_topk(R)`` equals the reference's tournament (interpret
    mode) and the first ``fetch`` keys of ``np.sort``."""
    keys = _keys(0.002 if case == "sentinel_heavy" else 0.35)
    if case == "sentinel_heavy":
        assert 0 < (keys != tbk.SENT).sum(axis=1).min() < fetch
    if case == "fetch_is_blocks":
        assert fetch == keys.shape[1] // R
    got = _broad_topk(torch.from_numpy(keys), fetch_rows=fetch, R=R)
    want = np.sort(keys, axis=1)[:, :fetch]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_reference(ref, keys, fetch, R), want)


def test_key_builder_draw_order():
    """The port's key builder draws as the reference's main does: scores,
    then the matched mask, from seed 0, keys unique where matched."""
    rng = np.random.default_rng(0)
    score = rng.integers(0, 520, (2, 4096)).astype(np.int64)
    matched = rng.random((2, 4096)) < 0.35
    keys = tbk.make_keys(np.random.default_rng(0), 2, 4096)
    idx = np.arange(4096, dtype=np.int64)
    want = np.where(matched, ((0xFFFF - score) << 36) | (idx << 16), tbk.SENT)
    np.testing.assert_array_equal(keys, want)
    m = keys[0] != tbk.SENT
    assert len(np.unique(keys[0][m])) == m.sum()


def test_probe_on_cpu(capsys):
    """The probe's records on the CPU at a small shape: the tournament at
    R 64 and 128, ``torch.topk`` and the gather all equal their
    references, times null, exit code 0."""
    assert tbk.emit(tbk.run(torch.device("cpu"), q=2, t=16384,
                            fetch=64)) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[:3] == [{"R": 64, "exact_equal": True},
                         {"R": 128, "exact_equal": True},
                         {"topk_equal": True}]
    keys = set().union(*lines)
    assert {"full_sort_ms", "tournament_ms", "blockmin_sort_ms",
            "gather_only_ms_R128", "topk_ms", "index_select_ms_R128",
            "gather_equal"} <= keys
    assert all(v is None for x in lines for k, v in x.items()
               if k.endswith("_ms"))


def test_probe_refuses_too_few_blocks():
    with pytest.raises(ValueError, match="fewer than"):
        list(tbk.run(torch.device("cpu"), q=1, t=4096, fetch=64))
