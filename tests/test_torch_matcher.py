"""The port's serving API — ``match_topk_batch`` and its pipelined form —
against frizbee_tpu's ``match_topk_batch`` and its host oracle
(``Matcher(use_device=False)``) on small datagen corpora, plus the
empty query's copy path, the queries and corpora the generic pipelines
serve (refused before they were ported) and the package's import
boundary."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from frizbee_tpu.config import Config as JConfig
from frizbee_tpu.config import Matching as JMatching
from frizbee_tpu.config import SortStrategy as JSortStrategy
from frizbee_tpu.corpus import pack_corpus as j_pack
from frizbee_tpu.matcher import Matcher as JMatcher
from frizbee_tpu.matcher import match_topk_batch as j_topk
from frizbee_tpu_torch import (
    Config,
    Matcher,
    SortStrategy,
    datagen,
    match_topk_batch,
    match_topk_batch_async,
    pack_corpus,
)
from frizbee_tpu_torch.config import Matching

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ["deadbeef", "feedbead", "dead", "DeadBeef", "bee", "fade"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_topk_parity(hay, queries, k, **cfg):
    corpus = pack_corpus(hay, device="cpu")
    got = match_topk_batch(queries, corpus, Config(**cfg), k=k)
    ref_corpus = j_pack(hay, unicode=False)
    jcfg = JConfig(**{
        key: JSortStrategy[v.name] if key == "sort" else v
        for key, v in cfg.items()
    })
    want = j_topk(queries, ref_corpus, jcfg, k=k)
    for q, g, w in zip(queries, got, want):
        assert g[0] == w[0], q
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
        oracle = JMatcher.from_query(
            q, jcfg, use_device=False
        ).match_arrays(ref_corpus)
        assert g[0] == len(oracle[0])
        for a, b in zip(g[1:], oracle):
            np.testing.assert_array_equal(a, b[:k])
    return got


def test_topk_partial_corpus():
    hay = datagen.partial_match_corpus(median_length=20, num_samples=3000,
                                       seed=3)
    got = _assert_topk_parity(hay, QUERIES, 30)
    assert got[0][0] > 30 and len(got[0][1]) == 30


def test_topk_multi_bucket_corpus_typos():
    hay = datagen.partial_match_corpus(median_length=24, num_samples=1800,
                                       seed=11)
    hay += [h * 7 for h in datagen.partial_match_corpus(
        median_length=12, num_samples=1500, seed=12)]
    _assert_topk_parity(hay, ["deadbeef", "dbeef", "feed"], 25,
                        max_typos=1)


def test_topk_score_then_index_desc():
    hay = datagen.all_match_corpus(median_length=16, num_samples=1200,
                                   seed=4)
    # k covers every match: the descending-index reorder is then the
    # oracle's order too
    _assert_topk_parity(hay, ["deadbeef", "dead"], 1500,
                        sort=SortStrategy.SCORE_THEN_INDEX_DESC)


def test_async_equals_blocking():
    """Several futures in flight return what the blocking call returns,
    and result() is idempotent."""
    hay = datagen.partial_match_corpus(median_length=20, num_samples=2000,
                                       seed=9)
    corpus = pack_corpus(hay, device="cpu")
    sync = match_topk_batch(QUERIES, corpus, Config(), k=40)
    futs = [match_topk_batch_async(QUERIES, corpus, Config(), k=40)
            for _ in range(3)]
    for f in futs:
        res = f.result()
        assert res is f.result()
        for a, b in zip(res, sync):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("query,cfg,match", [
    ("^deadbeefdeadbeefa", {}, "literal"),
    ("deadbeefdeadbeefa", {"matching": Matching.SUBSTRING}, "literal"),
    ("dead deadbeefdeadbeefdead", {}, "generic pipelines"),
    ("abc إن", {}, "generic pipelines"),
    ("^" + "é" * 17, {}, "generic pipelines"),
    ("deadbeef" * 8 + "a", {}, "generic pipelines"),
    ("deadbeefdeadbeef", {"max_typos": 9}, "generic pipelines"),
    ("^deadbeefd", {"max_typos": 9}, "generic pipelines"),
    ("dead", {"sort": SortStrategy.INDEX_ASC}, "index sort"),
])
def test_unserved_queries_raise(query, cfg, match):
    """Queries the reference serves through its generic pipelines (``match``
    names the refusal the device path raised before they were ported):
    the device path now equals the reference's device path and its host
    oracle."""
    hay = ["deadbeef", "abc إن", "deadbeefdeadbeefabc", "é" * 18,
           "x_deadbeefdeadbeefdeadbeef", "deadbeef" * 9, "dead abc إن"]
    jcfg = JConfig(**{
        key: (JSortStrategy[v.name] if key == "sort"
              else JMatching[v.name] if key == "matching" else v)
        for key, v in cfg.items()
    })
    got = Matcher.from_query(query, Config(**cfg)).match_arrays(
        pack_corpus(hay, device="cpu"))
    for use_device in (True, False):
        want = JMatcher.from_query(
            query, jcfg, use_device=use_device).match_arrays(hay)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_empty_query_copy_path():
    """The empty query (formerly refused) takes the copy path: every row
    in index order (reversed under the descending sorts), score 0, as the
    reference and its oracle return."""
    hay = ["deadbeef", "", "x" * 2000, "abc"]
    corpus = pack_corpus(hay, device="cpu")
    ref = j_pack(hay, unicode=False)
    for sort in SortStrategy:
        cfg = Config(sort=sort)
        jcfg = JConfig(sort=JSortStrategy[sort.name])
        got = Matcher.from_query("", cfg).match_arrays(corpus)
        for use_device in (True, False):
            want = JMatcher.from_query(
                "", jcfg, use_device=use_device).match_arrays(ref)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    res = match_topk_batch(["", "dead"], corpus, Config(), k=2)
    want = j_topk(["", "dead"], ref, JConfig(), k=2)
    for g, w in zip(res, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_unserved_corpora_raise():
    # a row wider than the widest bucket is served on the host (XL row)
    hay = ["dead", "x" * 2000, "d" + "x" * 1500 + "ead"]
    got = match_topk_batch(["dead"], pack_corpus(hay, device="cpu"))
    want = j_topk(["dead"], j_pack(hay, unicode=False), JConfig())
    assert got[0][0] == want[0][0] == 2
    for a, b in zip(got[0][1:], want[0][1:]):
        np.testing.assert_array_equal(a, b)
    # custom bucket widths (formerly refused) take the generic pipelines
    hay = ["dead", "deadbeef", "xdeadx"] * 10
    got = match_topk_batch(["dead"], pack_corpus(
        hay, bucket_widths=(48,), device="cpu"))
    want = j_topk(["dead"], j_pack(hay, unicode=False, bucket_widths=(48,)),
                  JConfig())
    assert got[0][0] == want[0][0] == 30
    for a, b in zip(got[0][1:], want[0][1:]):
        np.testing.assert_array_equal(a, b)
    # a typo budget beyond 8: clamped to 8 by an 8-unit needle (the
    # kernels), or over 8 on a longer one (formerly refused; the generic
    # pipeline)
    hay = ["deadbeef", "deadbeefd", "xyz"]
    corpus = pack_corpus(hay, device="cpu")
    for q in ("deadbeef", "deadbeefd"):
        got = Matcher.from_query(q, Config(max_typos=9)).match_arrays(corpus)
        want = JMatcher.from_query(q, JConfig(max_typos=9)).match_arrays(hay)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(got[0]) == 3


def _port_files():
    pkg = os.path.join(ROOT, "frizbee_tpu_torch")
    for base, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "kernel_probe.py")


def test_port_imports_no_jax_and_no_reference():
    """The port runs where JAX is absent: no file of the package (its
    probes included), and neither chip_smoke.py nor kernel_probe.py,
    imports jax, frizbee_tpu or the reference's benchmarks; and no native
    source of the port (``native/*.c``, ``*.cpp``) names the reference
    package (a module it imports, or a type name it pickles under)."""
    files = list(_port_files())
    assert len(files) > 10
    scanned = {os.path.relpath(p, ROOT) for p in files}
    for rel in ("ops/literal.py", "ops/kernels.py", "ops/batch.py",
                "ops/fuzzy.py", "ops/presence.py",
                "ops/pairing.py", "engine.py", "corpus.py", "types.py",
                "sort.py", "matcher.py", "traceback.py", "native/__init__.py",
                "oracle/prefilter.py", "oracle/smith_waterman.py",
                "oracle/greedy.py", "oracle/literal.py",
                "probes/__init__.py",
                "probes/broad_topk.py", "probes/transposed.py",
                "probes/colstream_bisect.py", "parallel.py",
                "profiling.py"):
        assert os.path.join("frizbee_tpu_torch", rel) in scanned
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "frizbee_tpu",
                                    "benchmarks"), (
                    f"{path} imports {name}"
                )
    native_dir = os.path.join(ROOT, "frizbee_tpu_torch", "native")
    sources = sorted(f for f in os.listdir(native_dir)
                     if f.endswith((".c", ".cpp")))
    assert sources == ["fastmatch.c", "packer.cpp"]
    for f in sources:
        with open(os.path.join(native_dir, f)) as fh:
            text = fh.read()
        hits = re.findall(r"frizbee_tpu(?!_torch)\S*", text)
        assert not hits, f"native/{f} names the reference: {hits}"
