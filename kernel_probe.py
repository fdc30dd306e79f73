"""A/B of the package's CUDA kernels on one card, each built from one of
several kernel source directories and timed in turns on the launches that
served batches make, with the ten serving batches served by each.

    python3 kernel_probe.py --variant parent=DIR \\
        --variant tree=frizbee_tpu_torch/csrc

Run it from the repository root, beside ``chip_smoke.py``, whose corpora,
serving paths and timing helpers it uses. A variant is LABEL=DIR, where
DIR holds the ``csrc`` sources of a kernel tree (for example those of an
unpacked ``git archive`` of an earlier commit) whose C entry points take
the package's arguments; sources from before the int16 lanes, whose
entry points lack the ``int16_lanes`` parameter, are built from a copy
with that parameter added and unused (``ABI_ADDED``), so they serve the
int16-lane requests in int32 lanes, as they did. The probe builds every kernel of ``KERNELS``
from each, builds ``chip_smoke.py``'s serving corpora (1M ASCII rows, 1M
rows for the 24-byte needle, 1M Arabic rows) and captures the launches of
one batch of each serving path. Then, for ``ROUNDS`` rounds, the variants
in turn (first to last, then back):

- ``row_gather`` on each path's captured gathers: device ms beside
  ``torch.index_select`` on the same arguments and the byte bound;
- each match kernel instantiation on the launches of the batches it
  serves (``MATCH_PATHS``: the column-stream fuzzy kernel on the fuzzy
  and unicode fuzzy batches, the literal kernel on the literal and
  unicode literal batches, ``match_units`` on the typo, long-needle,
  wide-scoring typo and unicode-typo batches, in int32 lanes; the int16
  instantiations of both DP kernels on the same launches of the fuzzy,
  typo and long-needle batches): device ms;
- the lane contract kernel on ``contract.contract_inputs``: device ms;
- each serving path as ``chip_smoke.py``'s serving phase drives it
  (warm-up, the median of 3 blocking batches, a depth-3 pipeline).

Every kernel result is held bit-equal to its plain version. Per path and
variant the summary gives the median over the rounds and, for two
variants, the share of rounds in which the second was faster. Writes
``chiprun_out/kernel_probe.json``; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs_
from frizbee_tpu_torch import datagen, pack_corpus
from frizbee_tpu_torch.ops import _build
from frizbee_tpu_torch.ops import colstream as cs
from frizbee_tpu_torch.ops import contract as ct
from frizbee_tpu_torch.ops import kernels as km
from frizbee_tpu_torch.probes import device_ms

ROUNDS = 10
KERNELS = ("row_gather", "match_units", "colstream_fuzzy",
           "colstream_literal", "lane_contract")
# match kernel instantiation -> (wrapper, plain version, its int16_lanes
# argument, the serving paths whose launches of that kernel it is timed
# on); int32 and int16 alike take each path's launches of the kernel,
# whichever lanes served them
MATCH_PATHS = {
    "match_units": (km.match_units, km.match_units_plain, False,
                    ("typo", "typo_wide", "long_needle", "unicode_typo")),
    "match_units_i16": (km.match_units, km.match_units_plain, True,
                        ("typo", "long_needle")),
    "colstream_fuzzy": (cs.match_units_colstream,
                        cs.match_units_colstream_plain, False,
                        ("fuzzy", "unicode_fuzzy")),
    "colstream_fuzzy_i16": (cs.match_units_colstream,
                            cs.match_units_colstream_plain, True,
                            ("fuzzy",)),
    "colstream_literal": (cs.match_units_colstream,
                          cs.match_units_colstream_literal_plain, None,
                          ("literal", "unicode_literal")),
}
# entry-point parameters added since earlier kernel trees: (source, the
# text it replaces, its replacement); a tree whose source never names the
# parameter gets it, unused
ABI_ADDED = (
    ("match_units.cu", "int unicode, const void* scoring",
     "int unicode, int /* int16_lanes */, const void* scoring"),
    ("colstream_fuzzy.cu", "int unicode, int T,",
     "int unicode, int /* int16_lanes */, int T,"),
)
# serving metric (ms) -> the key of chip_smoke._serve that holds it (s)
SERVING_METRICS = {"blocking_ms": "blocking_batch_seconds",
                   "pipelined_ms": "pipelined_batch_seconds"}


def _adapt(label: str, csrc: str) -> str:
    """``csrc``, or, where its entry points predate a parameter of
    ``ABI_ADDED``, a copy under the build directory with it added."""
    todo = []
    for name, old, new in ABI_ADDED:
        with open(os.path.join(csrc, name)) as fh:
            src = fh.read()
        if "int16_lanes" not in src:
            if src.count(old) != 1:
                raise ValueError(f"{csrc}/{name}: cannot add int16_lanes")
            todo.append((name, src.replace(old, new)))
    if not todo:
        return csrc
    dst = os.path.join(_build.BUILD_DIR, f"variant_{label}")
    shutil.copytree(csrc, dst, dirs_exist_ok=True)
    for name, src in todo:
        with open(os.path.join(dst, name), "w") as fh:
            fh.write(src)
    return dst


def _use(csrc: str) -> dict:
    """Launch ``KERNELS`` built from ``csrc`` from now on; returns the
    build's ptxas reports (empty for a library already built)."""
    _build.CSRC = os.path.abspath(csrc)
    _build._LIBS.clear()
    return {k: v["log"] for k, v in _build.build(KERNELS).items()}


def _summary(samples: dict, labels: list) -> dict:
    """Median of each variant's samples and, for two variants, the share
    of rounds in which the second took less time than the first and the
    mean of the second minus the first over the rounds with its standard
    error."""
    out = {"median": {v: float(np.median(samples[v])) for v in labels}}
    if len(labels) == 2:
        a, b = (np.asarray(samples[v]) for v in labels)
        d = b - a
        out[f"{labels[1]}_faster_share"] = float(np.mean(b < a))
        out["diff_mean"] = float(d.mean())
        out["diff_se"] = (float(d.std(ddof=1) / np.sqrt(len(d)))
                          if len(d) > 1 else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="LABEL=DIR of csrc sources (repeat; the first "
                         "one's kernels serve the captured batch)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    variants = {label: _adapt(label, d) for label, d in
                (v.split("=", 1) for v in args.variant)}
    labels = list(variants)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    out = {"nvidia_smi": smi, "variants": variants, "rounds": ROUNDS}

    t0 = time.perf_counter()
    out["build"] = {v: _use(variants[v]) for v in labels}
    print(f"built {len(labels)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    hay = datagen.partial_match_corpus(median_length=cs_.MEDIAN_LEN,
                                       num_samples=cs_.N_ROWS)
    corpus = pack_corpus(hay)
    long_corpus = pack_corpus(cs_._long_corpus(cs_.N_ROWS))
    ucorpus = pack_corpus(cs_._unicode_corpus(cs_.N_ROWS), unicode=True)
    paths = cs_._paths(corpus, long_corpus, ucorpus)
    _use(variants[labels[0]])
    calls = {}
    for p, (c, queries, cfg, _k) in paths.items():
        cs_._capture(c, queries, cfg)  # warm-up
        calls[p] = cs_._capture(c, queries, cfg)
    gathers = {p: [c for k, c in v if k == "row_gather"]
               for p, v in calls.items()}
    gathers = {p: g for p, g in gathers.items() if g}
    match = {(k, p): [(a, kw if lanes is None
                           else dict(kw, int16_lanes=lanes))
                          for name, (a, kw) in calls[p]
                          if name.removesuffix("_i16")
                          == k.removesuffix("_i16")]
             for k, (_f, _pl, lanes, kpaths) in MATCH_PATHS.items()
             for p in kpaths}
    print("captured " + json.dumps(
        {p: {k: sum(1 for name, _c in calls[p] if name == k)
             for k in KERNELS} for p in paths}), flush=True)
    errs = {k: 0.0 for k in (*KERNELS, *MATCH_PATHS)}
    contract_in = ct.contract_inputs(seed=1, device=corpus.device)
    want_c = ct.contract_plain(*contract_in, km.DEFAULT_SCORING)
    want_g = {p: [cs.row_gather_plain(*a) for a, _kw in g]
              for p, g in gathers.items()}
    want_m = {(k, p): [MATCH_PATHS[k][1](*a, **kw) for a, kw in c]
              for (k, p), c in match.items()}

    def run(fn, cl):
        return [fn(*a, **kw) for a, kw in cl]

    def held(name, fn, cl, want, what):
        got = run(fn, cl)
        torch.cuda.synchronize()
        for x, w in zip(got, want):
            cs_._check_equal(errs, name, x, w, what)

    gather_out, match_out = {}, {}
    for p, g in gathers.items():
        read = written = 0.0
        for (a, kw), w in zip(g, want_g[p]):
            _ops, i, o = cs_._gather_work(a, kw, w)
            read, written = read + i, written + o
        gather_out[p] = {"launches": len(g), "bytes": read + written,
                         "bound_ms": cs_._bound(read, written, 0.0)[0],
                         "index_select_ms": [],
                         "ms": {v: [] for v in labels}}
    for (k, p), c in match.items():
        match_out.setdefault(k, {})[p] = {"launches": len(c),
                                          "ms": {v: [] for v in labels}}
    serving = {p: {m: {v: [] for v in labels} for m in SERVING_METRICS}
               for p in paths}
    contract_out = {"ms": {v: [] for v in labels}}

    for r in range(ROUNDS):
        for v in (labels if r % 2 == 0 else labels[::-1]):
            _use(variants[v])
            for p, g in gathers.items():
                held("row_gather", cs.row_gather, g, want_g[p], f"{v} {p}")
                gather_out[p]["ms"][v].append(
                    device_ms(lambda: run(cs.row_gather, g), reps=10))
                gather_out[p]["index_select_ms"].append(device_ms(
                    lambda: run(lambda d, i: torch.index_select(d, 0, i), g),
                    reps=10))
            for (k, p), c in match.items():
                fn = MATCH_PATHS[k][0]
                held(k, fn, c, want_m[k, p], f"{v} {p}")
                match_out[k][p]["ms"][v].append(
                    device_ms(lambda: run(fn, c)))
            got = ct.lane_contract(*contract_in, km.DEFAULT_SCORING)
            torch.cuda.synchronize()
            for x, w in zip(got, want_c):
                cs_._check_equal(errs, "lane_contract", x, w, v)
            contract_out["ms"][v].append(device_ms(
                lambda: ct.lane_contract(*contract_in, km.DEFAULT_SCORING),
                reps=10))
            for p, (c, queries, cfg, kernels) in paths.items():
                res = cs_._serve(p, c, queries, cfg, kernels, {})
                for m, key in SERVING_METRICS.items():
                    serving[p][m][v].append(res[key] * 1e3)
        print(f"round {r} done", flush=True)

    out["max_abs_err"] = errs
    out["row_gather"] = {
        p: {**e, "summary": {
            **_summary(e["ms"], labels),
            "index_select_median": float(np.median(e["index_select_ms"]))}}
        for p, e in gather_out.items()}
    for k, per_path in match_out.items():
        out[k] = {p: {**e, "summary": _summary(e["ms"], labels)}
                  for p, e in per_path.items()}
    out["lane_contract"] = {**contract_out,
                            "summary": _summary(contract_out["ms"], labels)}
    out["serving_ms"] = {p: {m: {"samples": s, **_summary(s, labels)}
                             for m, s in ms.items()}
                         for p, ms in serving.items()}
    os.makedirs(cs_.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs_.OUT_DIR, "kernel_probe.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({
        "max_abs_err": errs,
        "row_gather": {p: e["summary"] for p, e in out["row_gather"].items()},
        **{k: {p: e["summary"] for p, e in out[k].items()}
           for k in MATCH_PATHS},
        "lane_contract": out["lane_contract"]["summary"],
        "serving_ms": {p: {m: {k: x for k, x in e.items() if k != "samples"}
                           for m, e in ms.items()}
                       for p, ms in out["serving_ms"].items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
