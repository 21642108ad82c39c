"""Readings for the limits of `correct`: a cell's run on each of several
seeds in one process, with the control beside it.

    python3 h100bench/tools/calibrate.py --workload v41_scan --seconds 4 --seeds 1 2 3 ...

Each seed drives the cell as a run does (its set-up, a short window at the
cell's own load, the check) and prints one JSON line of readings: the
program's numbers against the reference and, for each, the control's
(the reference in TF32) and, for training, the reference trained with half
of every batch left out. The limits in limits/<workload>.json are set from
these lines (PERF.md gives them).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    sys.path.insert(0, ROOT)
    from h100bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="the first this many seeds run the control too")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--witness", type=int, default=0, help="training: also the reference trained in float64")
    ap.add_argument("--rate", type=float, default=None, help="a serving mix's rate, if not the cell's")
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    if args.rate is not None:
        cell = dataclasses.replace(cell, mix=dict(cell.mix, rate_per_s=args.rate))
    driver = harness.load_module("drivers", cell.mix["driver"])
    for k, seed in enumerate(args.seeds):
        t = time.time()
        control = k < args.control
        run = driver.run(cell, dict(seed=seed, seconds=args.seconds, trace=False, device="cuda",
                                    t0=t, control=control, witness=bool(args.witness)))
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": run.correct,
                           "readings": run.extra["readings"], "values": run.values,
                           "attempted": run.attempted, "failed": run.failed,
                           "seconds": time.time() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
