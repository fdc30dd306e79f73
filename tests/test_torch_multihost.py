"""Multi-controller serving in the port: gloo process groups on the CPU
through ``parallel.initialize_distributed``, as ``tests/test_multihost.py``
pins the reference's ``jax.distributed`` scaffold.

Each worker is a fresh ``python -c`` process that imports the port alone
(and asserts that neither ``jax`` nor ``frizbee_tpu`` was imported), joins
one gloo group through a ``file://`` rendezvous, feeds only its rank's
rows of the corpus, and runs: a collective smoke (``all_gather`` and
``all_reduce`` over the group); or ``match_corpus_sharded`` and
``match_topk_batch_sharded`` end to end, every rank's result equal to the
port's host oracle (``Matcher(use_device=False)``). The parent holds the
ranks' results equal to the reference's sharded serving at the same
shard count. Every worker has a hard timeout, which fails the test, and
tears its group down also on failure."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import frizbee_tpu.parallel as jp
from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.engine import make_engine as j_make_engine
from frizbee_tpu.matcher import Matcher as JMatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120

_PRELUDE = r"""
import json
import sys

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from frizbee_tpu_torch import parallel

mesh = parallel.initialize_distributed(
    init_method=init, world_size=world, rank=rank, device="cpu")
"""

_EPILOGUE = r"""
finally:
    dist.destroy_process_group()
assert "jax" not in sys.modules and "frizbee_tpu" not in sys.modules, (
    sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                         "frizbee_tpu")))
"""

WORKER = _PRELUDE + r"""
try:
    assert mesh.size == world and mesh.local_shards() == [
        (rank, torch.device("cpu"))]
    assert dist.get_backend() == "gloo"
    x = torch.arange(3, dtype=torch.int32) + 10 * rank
    g = parallel._all_gather(mesh, [x])
    assert g.tolist() == [[10 * r, 10 * r + 1, 10 * r + 2]
                          for r in range(world)], g
    s = parallel._psum(mesh, [x])
    assert s.tolist() == [sum(10 * r + i for r in range(world))
                          for i in range(3)], s
    print("MULTIHOST_OK", rank, world, flush=True)
""" + _EPILOGUE

HAY = (
    ["%d deadbeef" % i for i in range(7)]
    + ["d-e-a-d beef %d" % i for i in range(9)]
    + ["nothing here %d" % i for i in range(24)]
    + ["Dead/Beef%d" % i for i in range(8)]
)
QUERIES = ["deadbeef", "dead", "beef", "'dead", "dead !beef", "^Dead"]
K = 16

WORKER_E2E = _PRELUDE + f"""
HAY = {HAY!r}
QUERIES = {QUERIES!r}
K = {K}
""" + r"""
try:
    from frizbee_tpu_torch import Config, Matcher, pack_corpus
    from frizbee_tpu_torch.engine import make_engine

    cfg = Config()
    # every process packs the same corpus; the feed sends only this
    # rank's rows of each bucket
    corpus = pack_corpus(HAY, device="cpu")
    index, score, exact, end_col = parallel.match_corpus_sharded(
        corpus, make_engine("deadbeef", cfg), mesh, k=K)
    hi, hs, he, hec = Matcher("deadbeef", cfg,
                              use_device=False).match_arrays(HAY)
    np.testing.assert_array_equal(index, hi[:K])
    np.testing.assert_array_equal(score, hs[:K])
    np.testing.assert_array_equal(np.asarray(exact, bool), he[:K])
    np.testing.assert_array_equal(end_col, hec[:K])
    batch = parallel.match_topk_batch_sharded(QUERIES, corpus, mesh, cfg,
                                              k=K)
    # the batch path built each view from this rank's host rows: no
    # bucket's whole arrays or presence planes went to the device
    assert not any(hasattr(b, a) for b in corpus.buckets
                   for a in ("_device_full", "_device_bits"))
    for views in parallel._mesh_pad_buckets(corpus, mesh):
        for v, b in zip(views, corpus.buckets):
            assert v.from_host and v.size == -(-b.size // world)
    for q, got in zip(QUERIES, batch):
        want = Matcher.from_query(q, cfg, use_device=False).match_arrays(HAY)
        assert got[0] == len(want[0]), (q, got[0], len(want[0]))
        for a, b in zip(got[1:], want):
            np.testing.assert_array_equal(np.asarray(a), b[:K])
    out = {"corpus": [np.asarray(a).tolist()
                      for a in (index, score, exact, end_col)],
           "batch": [[int(r[0])] + [np.asarray(a).tolist() for a in r[1:]]
                     for r in batch]}
    print("MULTIHOST_E2E_OK", rank, json.dumps(out), flush=True)
""" + _EPILOGUE


def _run_multi_process(worker, tmp_path, n_procs=2):
    """Start ``n_procs`` ranks of ``worker`` on one file rendezvous and
    return their outputs; fails when a rank fails or outlives
    WORKER_TIMEOUT seconds."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, str(rank), str(n_procs), init],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT,
        )
        for rank in range(n_procs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish in {WORKER_TIMEOUT} s")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(outs)[-3000:])
    return outs


def test_two_process_distributed_smoke(tmp_path):
    outs = _run_multi_process(WORKER, tmp_path)
    assert all("MULTIHOST_OK" in o for o in outs), outs


def _results(outs):
    res = []
    for o in outs:
        line = next(x for x in o.splitlines()
                    if x.startswith("MULTIHOST_E2E_OK"))
        res.append(json.loads(line.split(" ", 2)[2]))
    return res


@pytest.mark.parametrize("n_procs", (2, 4))
def test_match_sharded_e2e(tmp_path, n_procs):
    """Every rank reproduces the host oracle (asserted in the worker),
    and every rank's result equals the reference's sharded serving over
    as many shards on JAX's virtual CPU devices."""
    outs = _run_multi_process(WORKER_E2E, tmp_path, n_procs)
    res = _results(outs)
    assert len(res) == n_procs
    cfg = JConfig()
    jcorpus = j_pack(HAY, unicode=False)
    jmesh = jp.make_mesh(n_procs)
    want_corpus = jp.match_corpus_sharded(
        jcorpus, j_make_engine("deadbeef", cfg), jmesh, k=K)
    want_batch = jp.match_topk_batch_sharded(
        [JMatcher.from_query(q, cfg) for q in QUERIES], jcorpus, jmesh, cfg,
        k=K)
    for r in res:
        for g, w in zip(r["corpus"], want_corpus):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        for got, want in zip(r["batch"], want_batch):
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
