"""Training: `make_train_step`'s step over `BucketedLoader` batches.

Set-up makes the seed's weights on the card and a labelled dataset of
structures in memory, with neighbour ids from the benchmark's own kNN (as
a dataset build stores them). The loader takes the program's
`TrainConfig` defaults for atoms per batch and the batch cap, and the
mix's count of forked workers; the train state the mix's learning rate. One train state is built; set-up drives it
through its first three steps on the loader's first batches and keeps
their losses, the first gradient as Adam's state holds it after step 1,
and the weights' change after step 3. The window then goes on with the
same state and loader, epoch after epoch, for `--seconds`; the rate is the
real atoms of every step over the window's whole time, the last step
waited for. After the window the reference trains from the same weights
on the same three batches' structures, and the three numbers are held
against its own: each step's loss, the worst leaf's gradient norm and the
worst leaf's change norm.
"""

import statistics
import time

import numpy as np
import torch

from h100bench import common, harness, structures
from h100bench.reference import knn as ref_knn
from h100bench.reference import pesto as ref
from h100bench.reference import train as ref_train


class Items:
    """The dataset: items (X, ids, q, M, y) as the program's loader takes
    them, M expanded from residue indices at each read (in the loader's
    workers), as a dataset file's sparse masks are."""

    __slots__ = ("X", "ids", "q", "res", "n_res", "y", "sizes")

    def __init__(self, X, ids, q, res, n_res, y):
        self.X, self.ids, self.q, self.res, self.n_res, self.y = X, ids, q, res, n_res, y
        self.sizes = np.array([[len(x), r] for x, r in zip(X, n_res)])

    def __len__(self):
        return len(self.X)

    def __getitem__(self, i):
        M = (self.res[i][:, None] == np.arange(self.n_res[i])[None, :]).astype(np.float32)
        return self.X[i], self.ids[i], self.q[i], M, self.y[i]


def make_items(cell, seed, dev) -> Items:
    mix, cfg = cell.mix, cell.config
    law = mix["residues"]
    recs = structures.make_records(seed, mix["items"], law["median"], law["sigma"], law["min"],
                                   law["max"], max_atoms=mix["max_atoms"])
    rng = np.random.default_rng([int(seed), 2])
    X, ids, q, res, n_res, y = [], [], [], [], [], []
    for rec in recs:
        X.append(rec["xyz"])
        ids.append(ref_knn.knn(torch.from_numpy(rec["xyz"]).to(dev), dtype=torch.float32).cpu().numpy())
        q.append(ref.features(rec, cfg).numpy())
        r, n = ref.residues(rec)
        res.append(r.numpy())
        n_res.append(n)
        y.append((rng.random((n, cfg["dm_n2"])) < mix["positive_share"]).astype(np.float32))
    return Items(X, ids, q, res, n_res, y)


def run(cell, ctx) -> harness.Run:
    from pesto_tpu_torch.batching import to_device
    from pesto_tpu_torch.data.loader import BucketedLoader
    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.train.loop import TrainConfig
    from pesto_tpu_torch.train.state import create_train_state
    from pesto_tpu_torch.train.step import make_train_step

    cfg, mix, seed = cell.config, cell.mix, ctx["seed"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    tc = TrainConfig()
    if cuda:
        _build.build_all(("edge_attention", "edge_attention_bwd"))
    weights = ref.make_weights(cfg, seed, dev)
    start = {k: v.detach().clone() for k, v in weights.items()}
    state = create_train_state(common.program_config(cfg), learning_rate=mix["learning_rate"],
                               state_dict=weights, schedule=tc.lr_schedule, device=dev)
    del weights
    harness.note(ctx["t0"], "weights, train state, kernels")
    items = make_items(cell, seed, dev)
    harness.note(ctx["t0"], "items and their neighbours")
    loader = BucketedLoader(items, items.sizes, atoms_per_batch=tc.atoms_per_batch,
                            max_batch=tc.max_batch, shuffle=True, seed=int(seed) % (1 << 31),
                            num_workers=mix["loader_workers"],
                            compact=sum(common.program_config(cfg).feature_flags) == 1)
    step = make_train_step(tc.pos_weight_factor)
    params = dict(state.model.named_parameters())
    batches = iter(loader)

    def next_batch():
        nonlocal batches
        try:
            return next(batches)
        except StopIteration:
            batches = iter(loader)
            return next(batches)

    run = harness.Run(config=cfg)
    try:
        # the checked steps: the window's own call and feed
        checked, losses, grad_norms = [], [], None
        for _ in range(mix["checked_steps"]):
            hb = next_batch()
            checked.append(hb)
            state, out = step(state, to_device(hb, dev))
            losses.append(out["loss"])
            if grad_norms is None:
                beta1 = state.optimizer.param_groups[0]["betas"][0]
                moments = {k: state.optimizer.state.get(p, {}).get("exp_avg") for k, p in params.items()}
                grad_norms = {k: 0.0 if m is None else float((m / (1 - beta1)).double().norm())
                              for k, m in moments.items()}
        change = {k: float((p.detach() - start[k]).double().norm()) for k, p in params.items()}
        losses = [float(x) for x in losses]
        del start
        harness.note(ctx["t0"], "checked steps")

        pf = harness.load_module("costs", "pesto_forward")
        atoms_done = flops = 0.0
        waits, marks, step_losses, make_trace = [], [], [], None
        t_start = time.perf_counter()
        run.values["setup_s"] = time.time() - ctx["t0"]
        def one_step():
            nonlocal state, atoms_done, flops
            tw = time.perf_counter()
            hb = next_batch()
            waits.append(time.perf_counter() - tw)
            sizes = [(int(a), int(r)) for a, r in zip(hb.atom_mask.sum(axis=1), hb.res_mask.sum(axis=1))
                     if a > 0]
            mark = None
            if ctx["trace"] and cuda:
                ev = [torch.cuda.Event(enable_timing=True)]
                ev[0].record()
                marks.append(ev)

                def mark(name):
                    ev.append(torch.cuda.Event(enable_timing=True))
                    ev[-1].record()
            state, out = step(state, to_device(hb, dev), mark=mark)
            step_losses.append(out["loss"])
            atoms_done += sum(a for a, _ in sizes)
            flops += 3 * sum(pf.flops(cfg, a, r) for a, r in sizes)
            return sizes

        while time.perf_counter() - t_start < ctx["seconds"]:
            if ctx["trace"] and make_trace is None and time.perf_counter() - t_start >= ctx["seconds"] / 2:
                f0 = flops
                sizes, make_trace, spent = harness.profile(
                    lambda: [s for _ in range(mix["traced_steps"]) for s in one_step()])
                run.work["slice_structures"] = sizes
                run.work["excluded_s"], run.work["excluded_flops"] = spent, flops - f0
            else:
                one_step()
        if cuda:
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t_start
    finally:
        loader.close()
    run.attempted = len(step_losses)
    run.failed = sum(1 for x in step_losses if not torch.isfinite(x))
    run.values["train_atoms_per_s"] = atoms_done / run.window_s
    run.work["train_flops"] = flops
    if make_trace is not None:
        run.trace = make_trace()
    run.spans["loader.wait_s"] = waits
    if marks and cuda:
        parts = [[a.elapsed_time(b) for a, b in zip(ev, ev[1:])] for ev in marks if len(ev) == 4]
        run.spans["train_step.backward_ms"] = [p[1] for p in parts]
        run.spans["train_step.optimizer_ms"] = [p[2] for p in parts]
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del state, params, step, loader, batches, next_batch, one_step, step_losses
    common.free_memory()

    harness.note(ctx["t0"], "window closed")
    readings = check_readings(cell, seed, items, checked, losses, grad_norms, change, dev,
                              control=ctx.get("control", False), witness=ctx.get("witness", False))
    for name, lim in cell.limits.items():
        run.check(name, readings[name], lim["limit"])
    run.extra["readings"] = readings
    harness.note(ctx["t0"], "checked")
    return run


def _structures_of(items: Items, hb) -> list:
    """The items of a loader batch, found by their atom count and first
    atom (the reference takes its inputs from the items, not the batch)."""
    index = {(len(x), tuple(x[0].tolist())): i for i, x in enumerate(items.X)}
    out = []
    for j in range(hb.X.shape[0]):
        n = int(hb.atom_mask[j].sum())
        if n:
            i = index[(n, tuple(np.asarray(hb.X[j, 1], np.float32).tolist()))]
            out.append((items.X[i], items.ids[i], items.q[i], items.res[i], items.n_res[i], items.y[i]))
    return out


def gaps(prog, ref_out, exclude=()) -> dict:
    """The gaps of (losses, first gradient norms, change norms) against the
    reference's: each step's loss relative to the reference's (the first
    step's, `loss1_gap`, and the worst step's, `loss_gap`), and each leaf's
    norm against the reference's norm of that leaf or of the median leaf,
    whichever is larger, for the first gradient and for the change (the
    worst leaf and the median leaf; the change without the leaves in
    `exclude`)."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref_out

    def rel(p, r, keys):
        med = statistics.median(r[k] for k in keys)
        return [abs(p[k] - r[k]) / max(r[k], med) for k in keys]

    g = rel(pg, rg, list(rg))
    c = rel(pc, rc, [k for k in rc if k not in exclude])
    steps = [abs(a - b) / abs(b) for a, b in zip(pl, rl)]
    return {"loss1_gap": steps[0], "loss_gap": max(steps), "grad_gap": max(g),
            "grad_median_gap": statistics.median(g), "change_gap": max(c),
            "change_median_gap": statistics.median(c)}


def check_readings(cell, seed, items, checked, losses, grad_norms, change, dev, control=False,
                   witness=False) -> dict:
    """The three numbers of the program against the reference (and, with
    `control`, of the reference in TF32 and of the reference trained with
    half of each batch left out, each against the reference; with
    `witness`, of the program and of the reference against the reference
    in float64)."""
    cfg = cell.config
    batches = [_structures_of(items, hb) for hb in checked]
    lr = cell.mix["learning_rate"]

    def train(**kw):
        return ref_train.steps(cfg, ref.make_weights(cfg, seed, dev), batches, lr, dev, **kw)

    base = train()
    med = statistics.median(base[1].values())
    # leaves whose reference gradient is nought to rounding (a key MLP's
    # last bias under the softmax) move under Adam by round-off alone
    still = {k for k, g in base[1].items() if g < 1e-3 * med}
    out = gaps((losses, grad_norms, change), base, still)
    out["excluded_leaves"] = sorted(still)
    runs = []
    if control:
        runs += [("control", dict(kind="tf32")), ("half_batch", dict(drop_half=True))]
    if witness:
        runs += [("ref64", dict(dtype=torch.float64))]
    for name, kw in runs:
        other = train(**kw)
        out.update({f"{k}.{name}": v for k, v in gaps(other, base, still).items()})
        if name == "ref64":
            out.update({f"{k}.vs64": v for k, v in gaps((losses, grad_norms, change), other, still).items()})
            out["losses"] = {"program": losses, "ref32": base[0], "ref64": other[0]}
    return out
