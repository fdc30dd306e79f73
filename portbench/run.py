"""Run one cell of the benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with an NVIDIA card. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``); the numbers compared to decide ``correct`` come
last in it, under ``checks``, and are the last lines of standard error
too. The line before it holds notes: how many answers were checked and,
traced, the port's launch and route counters. Without a
card, or with modules of JAX or of the JAX package loaded after the
window or at any point up to the result line (the reference, the
roofline and the metric readers run in between), it prints no result
and exits non-zero. A cell on more than one card needs that many cards
and reads each of them.
"""

import argparse
import json
import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Cell.load(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()  # each card's allocator, before its peak is reset
    for i in range(chips):
        torch.cuda.reset_peak_memory_stats(i)
    t_start = harness.process_start_time() or T_START
    out, notes = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), t_start=t_start)
    banned = harness.banned_modules()
    if banned:
        print("modules of the JAX package or of JAX are loaded before the "
              f"result line: {banned}", file=sys.stderr)
        return 3
    print("notes: " + json.dumps(notes), flush=True)
    print(f"answers checked: {notes['answers_checked']}; phases (s): "
          + json.dumps(notes["phases_s"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out, ensure_ascii=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
