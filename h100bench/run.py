"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for. The run makes its weights and inputs from the seed, warms up the
cell's shapes (set-up), drives the cell's entry point for `--seconds`,
checks what the window produced against the plain reference, and prints
one JSON line last on standard output: end-to-end metrics with `--trace
0`, per-layer metrics (from a profiled slice of the window) with `--trace
1`. The numbers compared, each beside its limit, end standard error and
the line. It exits non-zero, with no line, where there is no card, where
the program cannot be imported, or where JAX or the JAX package was
loaded.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from h100bench import harness

    t0 = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "nv"))
    os.environ.setdefault("USE_FLAX", "0")

    cell = harness.find_cell(harness.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    return execute(cell, args, t0, "cuda")


def execute(cell, args, t0, device) -> int:
    """Drive the cell and print its line; `device` is "cuda" on the chip
    ("cpu" only in the harness's own tests)."""
    from h100bench import harness

    driver = harness.load_module("drivers", cell.mix["driver"])
    ctx = dict(seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device, t0=t0)
    run = driver.run(cell, ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"h100bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    if device == "cuda":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(run.memory_peak_bytes)}
        run.extra.setdefault("card", harness.power_limit())
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = harness.result_line(cell, run, bool(args.trace), dev)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
