"""The serving knee: a serving cell's run at each of several fixed rates,
in one process.

    python3 h100bench/tools/sweep_serve.py --workload v41_serve --seconds 20 --rates 10 20 30

For each rate it prints one JSON line: requests, answered, 429s, failures,
latency p50 / p95 from when each request was due, the generator's
lateness, and the p50 latency of the window's first and last thirds (a
queue that grows shows as a last third slower than the first). The knee
is the highest rate whose completions keep pace, with no 429 and no
growing lateness; the cell runs at 0.8 of it.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    sys.path.insert(0, ROOT)
    from h100bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    base = harness.find_cell(harness.load_spec(), args.workload)
    driver = harness.load_module("drivers", base.mix["driver"])
    for k, rate in enumerate(args.rates):
        cell = dataclasses.replace(base, mix=dict(base.mix, rate_per_s=rate))
        captured = {}
        run = driver.run(cell, dict(seed=args.seed + k, seconds=args.seconds, trace=False, device="cuda",
                                    t0=harness.process_start(), rows=captured))
        rows = np.array(captured["rows"])
        ok = rows[:, 3] == 200
        lat = (rows[:, 2] - rows[:, 0]) * 1e3
        third = args.seconds / 3
        first, last = ok & (rows[:, 0] < third), ok & (rows[:, 0] >= 2 * third)
        line = {"rate_per_s": rate, "requests": len(rows), "answered": int(ok.sum()),
                "status_429": int((rows[:, 3] == 429).sum()), "failed": run.failed,
                "p50_ms": float(np.percentile(lat[ok], 50)) if ok.any() else None,
                "p95_ms": run.values["serve_p95_ms"],
                "first_third_p50_ms": float(np.median(lat[first])) if first.any() else None,
                "last_third_p50_ms": float(np.median(lat[last])) if last.any() else None,
                "answered_by_window_end": int((ok & (rows[:, 2] <= args.seconds)).sum()),
                "loadgen": run.extra["loadgen"], "correct": run.correct}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
