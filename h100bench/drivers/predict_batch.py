"""Closed loop, one caller, over `Predictor.predict_batch`.

Set-up makes the seed's weights on the card, a pool of structure records
and a seeded order of the pool in calls of `per_call` records, then runs
every call once (the cell's shapes). The window cycles the calls until
`--seconds` have passed; the rate is the real atoms of every structure
answered over the window's whole time. After the window a seeded sample of
the answers (the largest structure among them) is held against the plain
reference.
"""

import time

import numpy as np
import torch

from h100bench import common, harness, structures
from h100bench.reference import pesto as ref


def run(cell, ctx) -> harness.Run:
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.ops import _build

    cfg, mix, seed = cell.config, cell.mix, ctx["seed"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    pred = Predictor(common.program_config(cfg), ref.make_weights(cfg, seed, dev), device=dev)
    if cuda:
        _build.build_all(("knn", "edge_attention"))
    harness.note(ctx["t0"], "weights, predictor, kernels")
    law = mix["residues"]
    recs = structures.make_records(seed, mix["pool"], law["median"], law["sigma"], law["min"],
                                   law["max"], max_atoms=mix["max_atoms"])
    order = np.random.default_rng([int(seed), 1]).permutation(len(recs))
    calls = [order[i : i + mix["per_call"]].tolist() for i in range(0, len(order), mix["per_call"])]
    atoms = np.array([len(r["xyz"]) for r in recs])
    n_res = np.array([int(r["resid"].max()) for r in recs])
    pf = harness.load_module("costs", "pesto_forward")
    flops = np.array([pf.flops(cfg, int(a), int(r)) for a, r in zip(atoms, n_res)], dtype=np.float64)

    harness.note(ctx["t0"], "records")
    for c in calls:
        pred.predict_batch([recs[i] for i in c])
    if cuda:
        torch.cuda.synchronize()
    harness.note(ctx["t0"], "warm-up: every call once")

    run = harness.Run(config=cfg)
    first = {}
    done = flop_sum = 0.0
    stage0 = dict(pred.stage_ms)
    t_start = time.perf_counter()
    run.values["setup_s"] = time.time() - ctx["t0"]
    k, make_trace = 0, None
    while time.perf_counter() - t_start < ctx["seconds"]:
        idx = calls[k % len(calls)]
        k += 1
        batch = [recs[i] for i in idx]
        if ctx["trace"] and make_trace is None and time.perf_counter() - t_start >= ctx["seconds"] / 2:
            out, make_trace, spent = harness.profile(lambda: pred.predict_batch(batch))
            run.work["slice_atoms"] = [int(atoms[i]) for i, o in zip(idx, out) if o is not None]
            run.work["excluded_s"] = spent
            run.work["excluded_flops"] = float(sum(flops[i] for i, o in zip(idx, out) if o is not None))
        else:
            out = pred.predict_batch(batch)
        for i, o in zip(idx, out):
            run.attempted += 1
            if o is None:
                run.failed += 1
                continue
            done += atoms[i]
            flop_sum += flops[i]
            first.setdefault(i, o)
    run.window_s = time.perf_counter() - t_start
    run.values["scan_atoms_per_s"] = done / run.window_s
    run.work["forward_flops"] = flop_sum
    if make_trace is not None:
        run.trace = make_trace()
    run.counters["structures"] = run.attempted
    run.counters["stage_ms"] = {s: pred.stage_ms[s] - stage0[s] for s in ("record_encode", "batch_encode",
                                                                          "device_wait")}
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del pred
    common.free_memory()

    harness.note(ctx["t0"], "window closed")
    picked = harness.sample(seed, first, atoms, mix["check_sample"])
    gaps = common.prob_gaps(cfg, seed, [recs[i] for i in picked], [first[i] for i in picked], dev,
                            control=ctx.get("control", False))
    for name, lim in cell.limits.items():
        run.check(name, gaps[name], lim["limit"])
    run.extra["readings"] = gaps
    harness.note(ctx["t0"], "checked")
    return run
