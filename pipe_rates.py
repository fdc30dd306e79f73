"""The card's issue rate for the integer instructions the probe kernels are
made of, measured: thread-instructions an SM a clock for each.

    python3 pipe_rates.py [--out chiprun_out/pipe_rates.json]

Each case is a kernel whose threads each run one instruction on eight
registers in a long unrolled loop, each step reading the next register
(so nothing folds and eight chains interleave), launched with enough blocks to fill every
SM; the rate is instructions / (kernel seconds x SMs x the SM clock that
``nvidia-smi`` reads during the run). The cases: the DPX instructions
(``__viaddmax_s16x2`` and its relu form, ``__vimax3_s16x2``,
``__vimax3_u16x2``, ``__vimax_s16x2_relu``), the ALU's ``IADD3``, ``LOP3``,
``PRMT`` and 32-bit max (``VIMNMX``), and the FMA pipe's ``IMAD``; and
pairs of them on alternate registers, whose rate is the pair's sum when
they issue to different pipes. ``cuobjdump -sass`` of the built library checks that each loop
body holds the instruction it names. Needs the card and ``nvcc``; builds
into ``frizbee_tpu_torch/_build/pipe_rates/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "frizbee_tpu_torch", "_build", "pipe_rates")

ITERS = 512
# (case, the SASS opcodes its loop body must hold, the C expressions of
# one step on accumulator a, b the next accumulator, with loop operands x
# and y; a case of two expressions runs them on alternate accumulators, so
# both pipes' rates add up if they are apart)
CASES = (
    ("viaddmax_s16x2", "VIADDMNMX", ("__viaddmax_s16x2(a, x, b)",)),
    ("viaddmax_s16x2_relu", "VIADDMNMX", ("__viaddmax_s16x2_relu(a, x, b)",)),
    ("vimax3_u16x2", "VIMNMX3", ("__vimax3_u16x2(a, x, b)",)),
    ("iadd3", "IADD3", ("a + b + x",)),
    ("lop3", "LOP3", ("(a ^ b) & x",)),
    ("prmt", "PRMT", ("__byte_perm(a, b, 0x5140)",)),
    ("max_s32", "VIMNMX", ("(unsigned)max((int)a, (int)b)",)),
    ("imad", "IMAD", ("a * b + x",)),
    ("dpx+iadd3", "VIADDMNMX IADD3",
     ("__viaddmax_s16x2(a, x, b)", "a + b + x")),
    ("dpx+prmt", "VIADDMNMX PRMT",
     ("__viaddmax_s16x2(a, x, b)", "__byte_perm(a, b, 0x5140)")),
    ("dpx+imad", "VIADDMNMX IMAD", ("__viaddmax_s16x2(a, x, b)", "a * b + x")),
    ("iadd3+imad", "IADD3 IMAD", ("a + b + x", "a * b + x")),
    ("prmt+iadd3", "PRMT IADD3", ("__byte_perm(a, b, 0x5140)", "a + b + x")),
)

SOURCE = r"""
#include <cuda_runtime.h>
#define STEP(R, S, E) { const unsigned a = R, b = S; R = (E); }
""" + "".join(f"""
__global__ void k_{name}(unsigned* out, unsigned seed, int iters) {{
  unsigned r0 = seed ^ threadIdx.x, r1 = r0 * 3u, r2 = r0 * 5u, r3 = r0 * 7u,
           r4 = r0 * 11u, r5 = r0 * 13u, r6 = r0 * 17u, r7 = r0 * 19u;
  unsigned x = seed * 0x9E3779B9u;
  for (int i = 0; i < iters; ++i) {{
#pragma unroll
    for (int u = 0; u < 16; ++u) {{
      STEP(r0, r1, {exprs[0]}) STEP(r1, r2, {exprs[-1]})
      STEP(r2, r3, {exprs[0]}) STEP(r3, r4, {exprs[-1]})
      STEP(r4, r5, {exprs[0]}) STEP(r5, r6, {exprs[-1]})
      STEP(r6, r7, {exprs[0]}) STEP(r7, r0, {exprs[-1]})
    }}
    x += 0x01010101u;
  }}
  out[blockIdx.x * blockDim.x + threadIdx.x] = r0 ^ r1 ^ r2 ^ r3 ^ r4 ^ r5 ^ r6 ^ r7;
}}
extern "C" int run_{name.replace("+", "_")}(void* out, unsigned seed, int iters, int blocks, int threads) {{
  k_{name.replace("+", "_")}<<<blocks, threads>>>((unsigned*)out, seed, iters);
  return (int)cudaGetLastError();
}}
""".replace(f"k_{name}(", f"k_{name.replace('+', '_')}(") for name, _op, exprs in CASES)


def _build():
    from frizbee_tpu_torch.ops import _build as build

    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "pipe_rates.cu")
    lib = os.path.join(BUILD, "libpipe_rates.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    return lib


def _sass_ops(lib):
    """{case: opcode counts of its kernel} from cuobjdump -sass (beside
    nvcc)."""
    from frizbee_tpu_torch.ops import _build as build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib],
                          capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : _Z\d+k_(\w+?)Pjji", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "pipe_rates.json"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pipe_rates: no CUDA device", file=sys.stderr)
        return 1
    lib_path = _build()
    lib = ctypes.CDLL(lib_path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = sms * 8, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sass = _sass_ops(lib_path)
    res = {"nvidia_smi": smi, "sms": sms, "cases": {}}
    for name, op, _expr in CASES:
        fn = getattr(lib, f"run_{name.replace('+', '_')}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        assert fn(out.data_ptr(), 1, 16, blocks, threads) == 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        assert fn(out.data_ptr(), 7, ITERS, blocks, threads) == 0
        end.record()
        # the SM clock while the kernel runs
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3
        mhz = float(clock.splitlines()[0])
        instr = blocks * threads * ITERS * 16 * 8
        rate = instr / (sec * sms * mhz * 1e6)
        res["cases"][name] = {"opcode": op, "ms": sec * 1e3,
                              "sm_clock_mhz": mhz,
                              "per_sm_per_clock": rate,
                              "sass": sass.get(name.replace("+", "_"), {})}
        print(json.dumps({name: res["cases"][name]}), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
