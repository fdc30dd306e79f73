"""Smoke run of frizbee_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``frizbee_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), then:

1. kernel phase: each kernel against its plain PyTorch version on the
   card, bit-equal, at the shapes of the 1M-row corpus — the column-stream
   kernel on every bucket (w64, w128, w256) for the Q=32 serving queries
   with T=0, T=1 and no prefilter, flags on and off, key-emit on and off;
   the row gather at the capped finalize and broad tournament shapes;
2. serving phase: bench.py's corpus (1M partial-match rows, median length
   64) and its Q=32 queries with k=2048 through ``match_topk_batch``
   (warm-up, blocking loop) and a depth-3 ``match_topk_batch_async``
   pipeline, with every launch counter set to 0 just before and read just
   after; both kernels must have launched;
3. timing phase: each kernel's time (CUDA events, warmed up) at the
   serving shapes beside its bound, its plain version and, for the row
   gather, ``torch.index_select``; the column-stream kernel's keys at the
   serving shapes are held bit-equal to the plain version's there too;
4. profile phase: torch.profiler over blocking batches (wall time,
   device busy time, top kernels and host operations) and cProfile over
   one batch;
5. card-versus-CPU phase: at 20k rows, Q=8, T in {0, 1} the (Q, 1+k, 2)
   serving arrays and the decoded top-k on the card equal the CPU's.

Prints the card's name and power limit first, one JSON ``kernels`` line
before the last, and ``{"ok": true, "device": {...}}`` last. Exits
non-zero, printing no result, when there is no CUDA device or any phase
fails. Details (per-phase seconds, ptxas reports) go to
``chiprun_out/chip_smoke_detail.json``.
"""

import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

N_ROWS = 1_000_000
MEDIAN_LEN = 64
Q = 32
TOP_K = 2048
DEPTH, RUNS = 3, 10

# H100 SXM peaks: device memory rate (NVIDIA data sheet), and the 32-bit
# integer ALU rate = 64 operations per SM per clock (add, compare,
# min/max, bitwise on sm_90: CUDA C++ guide's throughput table; the 128
# lanes per SM are the float32 pipe) x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations per (column, needle unit) cell of the colstream
# kernel: prefilter (2 compares, or, compare, and, or) and SW DP
PF_OPS_PER_CELL = 6
SW_OPS_PER_CELL = 14


def _queries(q):
    """bench.py's queries: distinct 8-char permutations of "deadbeef"."""
    rng = np.random.default_rng(99)
    base = "deadbeef"
    out = [base]
    while len(out) < q:
        s = "".join(rng.permutation(list(base)))
        if s not in out:
            out.append(s)
    return out[:q]


def _time_ms(fn, reps=5, warm=2):
    """Mean device time of fn() in ms, CUDA events around ``reps`` calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a, b):
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def _needles(queries):
    from frizbee_tpu_torch.matcher import Matcher

    return np.stack([
        np.concatenate(Matcher.from_query(q)._compiled[0].engine
                       ._host_needle()[:2])
        for q in queries
    ])


def _flags(blk_bits, needles_q, T):
    from frizbee_tpu_torch.ops.presence import (
        needle_need_matrix,
        presence_hits,
    )

    need, tot = needle_need_matrix(needles_q)
    return (presence_hits(blk_bits, need) >= (tot - T)[None, :]).T.to(
        torch.int32
    ).contiguous()


def kernel_phase(corpus, detail):
    """Each kernel against its plain version on the card, bit-equal."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    nq = torch.from_numpy(_needles(_queries(Q))).to(dev)
    errs = {"colstream_fuzzy": 0.0, "row_gather": 0.0}
    checks = 0
    for b in corpus.buckets:
        cpT, nuT, idxT, blk = b.device_arrays_colstream()
        scal = pack_needle_scalars(nq, b.size)
        for T, nopre in ((0, False), (1, False), (0, True)):
            flags = _flags(blk, nq, T)
            for fl in (flags, None):
                for ix in (idxT, None):
                    kw = dict(W=b.width, n=8, max_typos=T,
                              scoring=DEFAULT_SCORING, no_prefilter=nopre,
                              idx_bits=idx_bits)
                    got = cs.match_units_colstream(cpT, nuT, scal, fl, ix,
                                                   **kw)
                    torch.cuda.synchronize()
                    want = cs.match_units_colstream_plain(
                        cpT, nuT, scal, fl, ix, **kw)
                    pairs = [(got, want)] if ix is not None else list(
                        zip(got, want))
                    for g, w in pairs:
                        err = _max_abs_err(g, w)
                        errs["colstream_fuzzy"] = max(
                            errs["colstream_fuzzy"], err)
                        if err:
                            raise AssertionError(
                                f"colstream kernel != plain: w{b.width} "
                                f"T={T} no_prefilter={nopre} "
                                f"flags={fl is not None} "
                                f"keys={ix is not None} err={err}"
                            )
                    checks += 1
                    del got, want, pairs
    gather_shapes = _gather_shapes(corpus)
    g = torch.Generator(device=dev).manual_seed(5)
    for name, (R, C, M) in gather_shapes.items():
        data = torch.randint(-(2**31), 2**31 - 1, (R, C), generator=g,
                             dtype=torch.int32, device=dev)
        rows = torch.randint(0, R, (M,), generator=g, dtype=torch.int32,
                             device=dev)
        err = _max_abs_err(cs.row_gather(data, rows),
                           cs.row_gather_plain(data, rows))
        errs["row_gather"] = max(errs["row_gather"], err)
        if err:
            raise AssertionError(f"row_gather != plain at {name}")
        checks += 1
    detail["kernel_checks"] = checks
    print(f"kernel phase: {checks} kernel-vs-plain checks bit-equal "
          f"(colstream Q={Q} x {len(corpus.buckets)} buckets x "
          f"T=0,1,none x flags x key-emit; "
          f"row_gather {sorted(gather_shapes)})", flush=True)
    return errs


def _gather_shapes(corpus):
    """(R, C, M) of the row gather on the serving path: the capped
    finalize gathers cap of nG 1024-key groups per query (int64 keys as
    2048 int32 words), the tournament TOP_K of NB 128-key blocks."""
    from frizbee_tpu_torch.matcher import _colstream_finalize_cap
    from frizbee_tpu_torch.ops.batch import BROAD_TOPK_R

    n_g = sum(b.host_blk_bits().shape[0] for b in corpus.buckets)
    res = _colstream_finalize_cap(
        corpus, [(_needles(_queries(Q)), 0)], TOP_K)
    cap = res[0] if res is not None else -(-n_g // 4)
    nb = n_g * 1024 // BROAD_TOPK_R
    return {
        "capped": (Q * n_g, 2048, Q * cap),
        "broad": (Q * nb, 2 * BROAD_TOPK_R, Q * TOP_K),
    }


def serving_phase(corpus, detail):
    """The main path: match_topk_batch and the async pipeline."""
    from frizbee_tpu_torch import Config, match_topk_batch
    from frizbee_tpu_torch import match_topk_batch_async
    from frizbee_tpu_torch.ops import batch as fb
    from frizbee_tpu_torch.ops import colstream as cs

    queries = _queries(Q)
    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    for k in fb.FINALIZE_ROUTES:
        fb.FINALIZE_ROUTES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = match_topk_batch(queries, corpus, Config(), k=TOP_K)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = match_topk_batch(queries, corpus, Config(), k=TOP_K)
        times.append(time.perf_counter() - t0)
    blocking_s = float(np.median(times))
    t0 = time.perf_counter()
    futs = deque(match_topk_batch_async(queries, corpus, Config(), k=TOP_K)
                 for _ in range(DEPTH))
    done = 0
    for _ in range(RUNS):
        last = futs.popleft().result()
        done += 1
        futs.append(match_topk_batch_async(queries, corpus, Config(),
                                           k=TOP_K))
    while futs:
        last = futs.popleft().result()
        done += 1
    pipe_s = (time.perf_counter() - t0) / done
    batches = 1 + 3 + done
    launches = dict(cs.LAUNCHES)
    routes = dict(fb.FINALIZE_ROUTES)
    peak = torch.cuda.max_memory_allocated()

    assert res[0][0] > 0, "no match for the headline needle"
    for r, p in zip(res, last):
        assert len(r[1]) == min(TOP_K, r[0]), "result not k-capped"
        assert r[0] == p[0] and np.array_equal(r[1], p[1]), (
            "pipelined result differs from blocking")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    out = {
        "corpus_rows": len(corpus), "batch_queries": Q, "top_k": TOP_K,
        "warmup_batch_seconds": warm_s,
        "blocking_batch_seconds": blocking_s,
        "blocking_haystacks_per_sec": Q * len(corpus) / blocking_s,
        "pipelined_batch_seconds": pipe_s,
        "pipelined_haystacks_per_sec": Q * len(corpus) / pipe_s,
        "batches": batches, "launches": launches,
        "finalize_routes": routes,
        "peak_device_memory_bytes": peak,
        "first_query_count": int(res[0][0]),
    }
    detail["serving"] = out
    print("serving phase: " + json.dumps(out), flush=True)
    return out


def profile_phase(corpus, detail):
    """Where a serving batch's time goes: torch.profiler over blocking
    batches — wall time, device busy time, and the top device kernels
    and host operations."""
    from torch.profiler import ProfilerActivity, profile

    from frizbee_tpu_torch import Config, match_topk_batch

    queries = _queries(Q)
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            match_topk_batch(queries, corpus, Config(), k=TOP_K)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))

    # device-side events only (kernels, copies): the aten ops that
    # launched them carry the same time again
    dev_ops = sorted(
        (e for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=device_us, reverse=True,
    )
    busy_ms = sum(device_us(e) for e in dev_ops) / reps / 1e3
    host_ops = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)
    out = {
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "top_device_ms_per_batch": [
            [e.key[:80], device_us(e) / reps / 1e3, e.count // reps]
            for e in dev_ops[:10]
        ],
        "top_host_self_ms_per_batch": [
            [e.key[:80], e.self_cpu_time_total / reps / 1e3,
             e.count // reps]
            for e in host_ops[:12]
        ],
    }
    # host-side candidates: cProfile over one more batch (it slows
    # Python calls, so only the shares are read from it)
    import cProfile
    import pstats

    cprof = cProfile.Profile()
    cprof.enable()
    match_topk_batch(queries, corpus, Config(), k=TOP_K)
    torch.cuda.synchronize()
    cprof.disable()
    st = pstats.Stats(cprof)
    rows = sorted(
        ((v[3], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
         for k, v in st.stats.items()),
        reverse=True,
    )
    out["cprofile_top_cumulative_ms"] = [
        [name, sec * 1e3] for sec, name in rows[:25]
    ]
    detail["profile"] = out
    print("profile phase: " + json.dumps({
        k: out[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                            "device_idle_share")
    }) + " top device: " + json.dumps(out["top_device_ms_per_batch"][:5]),
        flush=True)


def timing_phase(corpus, serving, errs, detail):
    """Kernel times at the serving shapes beside bound, plain, library."""
    from frizbee_tpu_torch.ops import colstream as cs
    from frizbee_tpu_torch.ops.kernels import DEFAULT_SCORING
    from frizbee_tpu_torch.ops.kernels import pack_needle_scalars

    dev = corpus.device
    idx_bits = max((len(corpus) - 1).bit_length(), 1)
    nq = torch.from_numpy(_needles(_queries(Q))).to(dev)
    launches_per_batch = [
        (b.device_arrays_colstream(), b.size, b.width) for b in corpus.buckets
    ]
    args = []
    kernel_keys = []
    ops = 0.0
    in_bytes = out_bytes = 0
    for (cpT, nuT, idxT, blk), size, W in launches_per_batch:
        fl = _flags(blk, nq, 0)
        scal = pack_needle_scalars(nq, size)
        args.append((cpT, nuT, scal, fl, idxT, W))
        keys = cs.match_units_colstream(
            cpT, nuT, scal, fl, idxT, W=W, n=8, scoring=DEFAULT_SCORING,
            idx_bits=idx_bits)
        # work this run's data needs: every row of an alive group is
        # scanned to its length; a matched row's DP covers >= n columns
        nu = torch.clamp(nuT.reshape(-1), max=W).to(torch.float64)
        alive = fl.repeat_interleave(1024, dim=1).to(torch.float64)
        pf_cells = float((alive * nu[None, :]).sum()) * 8
        matched = float((keys != cs.INT64_MAX).sum())
        ops += pf_cells * PF_OPS_PER_CELL + matched * 8 * 8 * SW_OPS_PER_CELL
        in_bytes += (cpT.numel() + 4 * (nuT.numel() + idxT.numel()
                     + fl.numel() + scal.numel()))
        out_bytes += 8 * keys.numel()
        kernel_keys.append(keys)

    def run_kernel():
        for cpT, nuT, scal, fl, idxT, W in args:
            cs.match_units_colstream(
                cpT, nuT, scal, fl, idxT, W=W, n=8,
                scoring=DEFAULT_SCORING, idx_bits=idx_bits)

    plain_keys = []

    def run_plain():
        plain_keys[:] = [
            cs.match_units_colstream_plain(
                cpT, nuT, scal, fl, idxT, W=W, n=8,
                scoring=DEFAULT_SCORING, idx_bits=idx_bits)
            for cpT, nuT, scal, fl, idxT, W in args
        ]

    cs_ms = _time_ms(run_kernel)
    cs_plain_ms = _time_ms(run_plain, reps=1, warm=0)
    # the kernel's keys at the serving shapes, bit for bit
    for (_, _, _, _, _, W), got, want in zip(args, kernel_keys, plain_keys):
        err = _max_abs_err(got, want)
        errs["colstream_fuzzy"] = max(errs["colstream_fuzzy"], err)
        if err:
            raise AssertionError(
                f"colstream kernel != plain at the serving shape w{W}: "
                f"err={err}")
    del kernel_keys, plain_keys
    cs_bound_s = max((in_bytes + out_bytes) / HBM_BYTES_PER_S,
                     ops / INT32_OPS_PER_S)
    cs_bound_by = ("bytes" if (in_bytes + out_bytes) / HBM_BYTES_PER_S
                   >= ops / INT32_OPS_PER_S else "operations")
    batches = serving["batches"]
    entries = [{
        "name": "colstream_fuzzy",
        "route": "cuda",
        "source": "frizbee_tpu_torch/csrc/colstream_fuzzy.cu",
        "replaces": "frizbee_tpu/ops/colstream.py:954",
        "launches": serving["launches"]["colstream_fuzzy"],
        "max_abs_err": errs["colstream_fuzzy"],
        "ms": cs_ms,
        "plain_ms": cs_plain_ms,
        "bound_ms": cs_bound_s * 1e3,
        "bound_by": cs_bound_by,
        "library_ms": None,
    }]
    detail["colstream_timing"] = {
        "per": f"one serving batch ({len(args)} launches, Q={Q}, T=0)",
        "ops": ops, "bytes": in_bytes + out_bytes,
        "launches_per_batch": serving["launches"]["colstream_fuzzy"]
        / batches,
    }

    shapes = _gather_shapes(corpus)
    routes = serving["finalize_routes"]
    main = "capped" if routes["capped"] + routes["mixed"] else "broad"
    g = torch.Generator(device=dev).manual_seed(6)
    gather = {}
    for name, (R, C, M) in shapes.items():
        data = torch.randint(-(2**31), 2**31 - 1, (R, C), generator=g,
                             dtype=torch.int32, device=dev)
        rows = torch.randint(0, R, (M,), generator=g, dtype=torch.int32,
                             device=dev)
        gather[name] = {
            "shape": [R, C, M],
            "ms": _time_ms(lambda: cs.row_gather(data, rows)),
            "plain_ms": _time_ms(lambda: cs.row_gather_plain(data, rows)),
            "library_ms": _time_ms(
                lambda: torch.index_select(data, 0, rows)),
            "bound_ms": 2 * M * C * 4 / HBM_BYTES_PER_S * 1e3,
        }
        del data, rows
    detail["row_gather_timing"] = gather
    gm = gather[main]
    entries.append({
        "name": "row_gather",
        "route": "cuda",
        "source": "frizbee_tpu_torch/csrc/row_gather.cu",
        "replaces": "frizbee_tpu/ops/colstream.py:749",
        "launches": serving["launches"]["row_gather"],
        "max_abs_err": errs["row_gather"],
        "ms": gm["ms"],
        "plain_ms": gm["plain_ms"],
        "bound_ms": gm["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gm["library_ms"],
    })
    print(f"timing phase: colstream per batch {cs_ms:.4f} ms "
          f"(plain {cs_plain_ms:.1f} ms, bound {cs_bound_s * 1e3:.4f} ms "
          f"by {cs_bound_by}); row_gather "
          + json.dumps({k: {kk: vv for kk, vv in v.items()}
                        for k, v in gather.items()}), flush=True)
    return entries


def cpu_parity_phase(detail):
    """Reduced size: the card's serving arrays equal the CPU's."""
    from frizbee_tpu_torch import Config, datagen, match_topk_batch
    from frizbee_tpu_torch import pack_corpus
    from frizbee_tpu_torch.matcher import Matcher, _dispatch_batch_groups

    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=20_000, seed=7)
    on_card = pack_corpus(hay)
    on_cpu = pack_corpus(hay, device="cpu")
    queries = _queries(8)
    compared = 0
    for typos in (0, 1):
        cfg = Config(max_typos=typos)
        raw = []
        for corpus in (on_card, on_cpu):
            ms = [Matcher.from_query(q, cfg) for q in queries]
            pending = _dispatch_batch_groups(ms, corpus, cfg, TOP_K)
            (rows, ready, members), = pending
            if ready is not None:
                ready.synchronize()
            raw.append((rows.numpy().copy(), members))
        assert raw[0][1] == raw[1][1]
        assert np.array_equal(raw[0][0], raw[1][0]), (
            f"card and CPU serving arrays differ at max_typos={typos}")
        a = match_topk_batch(queries, on_card, cfg, k=TOP_K)
        b = match_topk_batch(queries, on_cpu, cfg, k=TOP_K)
        for x, y in zip(a, b):
            assert x[0] == y[0]
            for u, v in zip(x[1:], y[1:]):
                assert np.array_equal(u, v)
        assert a[0][0] > 0
        compared += raw[0][0].size
    detail["cpu_parity_elements"] = compared
    print(f"card-vs-CPU phase: {compared} serving-array elements equal "
          f"(20k rows, Q=8, T=0,1)", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from frizbee_tpu_torch import datagen, pack_corpus
    from frizbee_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    detail = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    detail["build"] = {k: {"seconds": v["seconds"], "ptxas": v["log"]}
                       for k, v in built.items()}
    print(smi, flush=True)
    print(f"kernel build: {build_s:.1f} s ({len(built)} libraries, "
          f"nvcc in parallel)", flush=True)

    t0 = time.perf_counter()
    hay = datagen.partial_match_corpus(median_length=MEDIAN_LEN,
                                       num_samples=N_ROWS)
    corpus = pack_corpus(hay)
    for b in corpus.buckets:
        b.device_arrays_colstream()
        b.device_presence_bits()
    torch.cuda.synchronize()
    detail["pack_seconds"] = time.perf_counter() - t0
    detail["buckets"] = [(b.width, b.size) for b in corpus.buckets]
    print(f"corpus: {len(corpus)} rows, buckets {detail['buckets']}, "
          f"generated and packed in {detail['pack_seconds']:.1f} s",
          flush=True)

    phases = {}
    t0 = time.perf_counter()
    errs = kernel_phase(corpus, detail)
    phases["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = serving_phase(corpus, detail)
    phases["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = timing_phase(corpus, serving, errs, detail)
    phases["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_phase(corpus, detail)
    phases["profile"] = time.perf_counter() - t0
    del corpus, hay
    t0 = time.perf_counter()
    cpu_parity_phase(detail)
    phases["cpu_parity"] = time.perf_counter() - t0
    detail["phase_seconds"] = phases
    detail["total_seconds"] = time.perf_counter() - t_start
    detail["kernels"] = entries

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_detail.json"), "w") as fh:
        json.dump(detail, fh, indent=1)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
