"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size (not run by the benchmark's own runs).

    python portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed, in one process: the cell is set up once; a window of the
program as it is gives the lower reading; the control (the reference in
the program's place, its ties in descending index order: the stated
order broken) gives the upper one; then one window with each fault
planted where the answers are produced (``check.FAULTS``: the previous
batch's answers served again, half of a batch left out, every best score
raised by one). One JSON line a seed: each reading's numbers compared.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, seconds: float, device: str = "cuda"):
    from portbench import check, harness
    from portbench.reference import Corpus, answer

    session = harness.Session(cell, seed, device)
    ledgers = {}
    for name in ("program", *check.FAULTS):
        ledgers[name] = check.Ledger(session.sampled)
        fault = check.FAULTS.get(name)
        session.serve(seconds, ledger=ledgers[name], fault=fault)
    session.release()
    ref = Corpus(session.rows, device)
    mix = cell.mix
    reference = check.reference_for(ref, mix["config"], mix["k"])
    out = {name: led.compare(reference) for name, led in ledgers.items()}
    # the control: the reference, ties reversed, answering each query the
    # program's window served
    control = check.Ledger(session.sampled)
    for q in session.sampled:
        if ledgers["program"].served.get(q):
            control.record([q], [answer(ref, q, mix["config"], mix["k"],
                                        ties="desc")])
    out["control"] = control.compare(reference)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
