"""Closed loop, one caller, over `Predictor.predict_pairs` (the dimer).

Set-up first checks that the program has that entry point and exits
non-zero at once where it has not. It then makes the seed's dimer weights
on the card, a pool of chains under the mix's size law, `pairs` pairs of
two chains by a seeded matching (each chain in at most one pair) in calls
of `per_call` pairs, and runs every call once (the cell's shapes). The
window cycles the calls until `--seconds` have passed; the rate is the
real atoms of both chains of every pair answered over the window's whole
time. After the window a
seeded sample of the pairs (the one with the largest n_a * n_b among
them) is held against the plain reference (`reference/cross.py`), each
chain of a pair one answer: `answer_error_ratio` as `common.prob_gaps`
defines it, with its readings beside it.
"""

import sys
import time

import numpy as np
import torch

from h100bench import common, harness, structures
from h100bench.reference import cross as rc
from h100bench.reference import knn as ref_knn
from h100bench.reference import pesto as ref


def reference_probs(cfg, seed, pairs, device, kinds):
    """{kind: [probabilities [n_res, C] of each chain, a pair's two in
    turn]} of the reference with the seed's weights, one pair at a time,
    in each precision of `kinds` ("float32", "tf32", "float64").
    Neighbours by float64 direct differences."""
    dev = torch.device(device)
    weights = rc.make_weights(cfg, seed, dev)
    models = {}
    for kind in kinds:
        models[kind] = rc.CrossModel(cfg).to(dev, torch.float64 if kind == "float64" else torch.float32)
        models[kind].load_state_dict(weights)
        models[kind].eval()
    out = {k: [] for k in kinds}
    with torch.no_grad():
        for pair in pairs:
            ids = [ref_knn.knn(torch.from_numpy(r["xyz"]).to(dev)) for r in pair]
            for kind in kinds:
                with ref.precision("float32" if kind == "float64" else kind):
                    sides = [rc.side(models[kind], r["xyz"], i, ref.features(r, cfg), *ref.residues(r), dev)
                             for r, i in zip(pair, ids)]
                    z = models[kind](*sides)
                out[kind] += [torch.sigmoid(x).double().cpu().numpy() for x in z]
    return out


def pair_gaps(cfg, seed, pairs, answers, device, control=False) -> dict:
    """`common.prob_gaps`'s numbers over the chains of the pairs: answers
    are (probs_a, probs_b) or None per pair. `answer_error_ratio`: each
    chain's mean gap from the reference in float64, in units of the float32
    reference's own mean gap from it there (or the median chain's,
    whichever is larger); the worst chain's. `prob_gap` and
    `prob_answer_gap` beside it; with `control`, the same of the
    reference in TF32 (`.control`)."""
    kinds = ("float32", "float64") + (("tf32",) if control else ())
    ref_p = reference_probs(cfg, seed, pairs, device, kinds)
    own = [float(np.abs(f - w).mean()) for f, w in zip(ref_p["float32"], ref_p["float64"])]
    unit = [max(o, float(np.median(own))) for o in own]
    chains = [c for a in answers for c in (a if a is not None else (None, None))]

    def numbers(got_all, tag=""):
        widest = answer = ratio = 0.0
        for got, f32, f64, u in zip(got_all, ref_p["float32"], ref_p["float64"], unit):
            if got is None or np.shape(got) != f32.shape:
                return {f"{k}{tag}": np.inf for k in ("answer_error_ratio", "prob_gap", "prob_answer_gap")}
            got = np.asarray(got, np.float64)
            d = np.abs(got - f32)
            widest, answer = max(widest, float(d.max())), max(answer, float(d.mean()))
            ratio = max(ratio, float(np.abs(got - f64).mean()) / u)
        return {f"answer_error_ratio{tag}": ratio, f"prob_gap{tag}": widest, f"prob_answer_gap{tag}": answer}

    out = numbers(chains)
    if control:
        out.update(numbers(ref_p["tf32"], ".control"))
    out["float32_own_gap"] = float(np.median(own))
    return out


def run(cell, ctx) -> harness.Run:
    from pesto_tpu_torch.infer import Predictor

    if not hasattr(Predictor, "predict_pairs"):
        print("h100bench: the program has no Predictor.predict_pairs", file=sys.stderr)
        raise SystemExit(4)
    from pesto_tpu_torch.ops import _build

    cfg, mix, seed = cell.config, cell.mix, ctx["seed"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    pred = Predictor(common.program_config(cfg), rc.make_weights(cfg, seed, dev), device=dev)
    layer = pred.model.csul[0]
    if (layer.cNh, layer.cNk) != (cfg["cross"]["cNh"], cfg["cross"]["cNk"]):
        raise ValueError(f"the program's cross heads {(layer.cNh, layer.cNk)}, the config states {cfg['cross']}")
    if cuda:
        _build.build_all(("knn", "edge_attention", "cross_attention"))
    harness.note(ctx["t0"], "weights, predictor, kernels")
    law = mix["residues"]
    recs = structures.make_records(seed, mix["pool"], law["median"], law["sigma"], law["min"],
                                   law["max"], max_atoms=mix["max_atoms"])
    # a seeded matching: each chain in at most one pair, so every seed
    # sends the size law's chains, paired anew
    if 2 * mix["pairs"] > len(recs):
        raise ValueError(f"{mix['pairs']} pairs of distinct chains need {2 * mix['pairs']} chains, "
                         f"the pool has {len(recs)}")
    order = np.random.default_rng([int(seed), 2]).permutation(len(recs))[: 2 * mix["pairs"]]
    pair_ids = [tuple(x) for x in order.reshape(-1, 2).tolist()]
    calls = [list(range(k, min(k + mix["per_call"], len(pair_ids))))
             for k in range(0, len(pair_ids), mix["per_call"])]
    atoms = np.array([len(r["xyz"]) for r in recs])
    n_res = np.array([int(r["resid"].max()) for r in recs])
    cf = harness.load_module("costs", "cross_forward")
    flops = np.array([cf.flops(cfg, int(atoms[i]), int(n_res[i]), int(atoms[j]), int(n_res[j]))
                      for i, j in pair_ids], dtype=np.float64)
    pair_atoms = np.array([atoms[i] + atoms[j] for i, j in pair_ids])

    def batch_of(idx):
        return [(recs[pair_ids[x][0]], recs[pair_ids[x][1]]) for x in idx]

    harness.note(ctx["t0"], "records")
    for c in calls:
        pred.predict_pairs(batch_of(c))
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
        batch = batch_of(idx)
        if ctx["trace"] and make_trace is None and time.perf_counter() - t_start >= ctx["seconds"] / 2:
            out, make_trace, spent = harness.profile(lambda: pred.predict_pairs(batch))
            answered = [pair_ids[x] for x, o in zip(idx, out) if o is not None]
            run.work["slice_atoms"] = [int(atoms[i]) for pair in answered for i in pair]
            run.work["slice_pairs"] = [(int(atoms[i]), int(atoms[j])) for i, j in answered]
            run.work["excluded_s"] = spent
            run.work["excluded_flops"] = float(sum(flops[x] for x, o in zip(idx, out) if o is not None))
        else:
            out = pred.predict_pairs(batch)
        for x, o in zip(idx, out):
            run.attempted += 1
            if o is None:
                run.failed += 1
                continue
            done += pair_atoms[x]
            flop_sum += flops[x]
            first.setdefault(x, o)
    run.window_s = time.perf_counter() - t_start
    run.values["scan_atoms_per_s"] = done / run.window_s
    run.work["forward_flops"] = flop_sum
    if make_trace is not None:
        run.trace = make_trace()
    run.counters["pairs"] = run.attempted
    run.counters["stage_ms"] = {s: pred.stage_ms[s] - stage0[s] for s in ("record_encode", "batch_encode",
                                                                          "device_wait")}
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del pred
    common.free_memory()

    harness.note(ctx["t0"], "window closed")
    products = np.array([atoms[i] * atoms[j] for i, j in pair_ids])
    picked = harness.sample(seed, first, products, mix["check_sample"])
    gaps = pair_gaps(cfg, seed, batch_of(picked), [first[x] for x in picked], dev,
                     control=ctx.get("control", False))
    for name, lim in cell.limits.items():
        run.check(name, gaps[name], lim["limit"])
    run.extra["readings"] = gaps
    harness.note(ctx["t0"], "checked")
    return run
