#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`pesto_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and when the package is
not beside this file). Phases, each of which fails the run on error:

  0. the card's name and power limit (nvidia-smi);
  1. build the four CUDA sources of pesto_tpu_torch/csrc (one nvcc each, in
     parallel);
  2. the kNN kernel against its plain version on the card: ids equal except
     on rows where the swapped neighbours' squared distances tie within
     fp32 rounding of the Gram form, ok equal; Dmax to rtol 1e-6; its
     Morton keys equal to their plain version and the ids-only entry
     (`knn_ids`, the main path's) equal to `knn_kernel`; per case the
     tie rows, the kernel's time (ids only, and with the Dmax pass), its
     device time by kernel, the share of pairs it evaluated, the largest
     fill of a row's candidate buffer and the rows whose buffer was cut,
     and the bound from the evaluated pairs beside the all-pairs bound;
     up to random clouds at protein density in file order at 32768 and
     131072 atoms;
  3. the edge-attention kernel against its plain version on the card at
     nn in {8,16,32,64}, N=8192 and a ragged N: fp32 atol 5e-5 / rtol 1e-4,
     bf16 atol 5e-2 / rtol 5e-2; its warm time at N=8192 on uniform random
     ids and on the main path's own ids (the kNN of the synthetic 8191-atom
     structure, first nn columns), beside its bounds (fp32: on the CUDA
     cores, and as 3xTF32 on the tensor cores, the kernel's scheme); the
     edge library's ptxas line (registers, shared memory, spills);
  4. the main path at full width: Predictor(i_v4_1, 32 layers, seeded random
     weights, device="cuda").predict_pdb_file on tests/goldens/1OL5_A_i0.pdb
     and on a synthetic 8191-atom structure (bucket 8192), with the launch
     counters set to 0 just before and read just after (1 kNN launch per
     structure, 32 edge launches per forward; each edge launch runs two
     kernels of csrc/edge_attention.cu, the per-atom pre-pass and the
     tile kernel, counts once, and is timed as a whole); the _i{0..4}.pdb files
     written and checked; the 1OL5 probabilities held against the same
     Predictor on the CPU (plain versions, fp32) at atol 1e-4; then, for
     each structure, the warm time of each stage and one forward under
     torch.profiler (device busy time and the operations that take it);
  5. the off-path kernels, those of the two experiment scripts
     (csrc/mosaic_repros.cu, csrc/exp_gather.cu): each against its plain
     version on the card, bit for bit, on seeded inputs that reach its
     branches, and its warm time at the scripts' shapes and, for the
     bisection and the row take, at the main path's (8192 atoms, 64
     neighbours), both by CUDA events over a loop of launches (the host's
     launch path included) and as device time under torch.profiler, as
     for the library call beside it; then both scripts run in subprocesses,
     `python -m pesto_tpu_torch.scripts.mosaic_repros` (every case) and
     `... .exp_gather all`, which must exit 0 and report the launches of
     their kernels (each script sets its counters to 0 when it starts).

The last three lines are the card's name and power limit, one JSON object
with each kernel's numbers, and {"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "1OL5_A_i0.pdb")

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores, bf16 and
# TF32 on the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

FP32_TOL = dict(atol=5e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
PROB_ATOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps=10, warmup=2):
    """Mean time of fn() over reps launches, by CUDA events."""
    import torch

    from pesto_tpu_torch.scripts import time_ms

    return time_ms(fn, torch.device("cuda"), reps, warmup)


def device_ms(fn, reps=20, warmup=2):
    """(ms, {kernel: ms}): the device time of one fn() call, the sum of
    the durations of the CUDA kernels it runs under torch.profiler, mean
    over reps calls, in all and by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return sum(by_name.values()), by_name


def short_name(kernel):
    """A CUDA kernel's name without its namespace and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[: min(len(name), *(i for i in (name.find("<"), name.find("(")) if i >= 0))]
    return (name.split() or [name])[-1].split("::")[-1][:40]


def bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """{"bound_ms", "bound_by"}: the least time the card could take, from
    the operations at the peak of their type and the bytes at the memory
    rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def morton_order(X, bits=10):
    """Indices that sort points along a Z-order curve."""
    import numpy as np

    lo, hi = X.min(0), X.max(0)
    g = ((X - lo) / np.maximum(hi - lo, 1e-6) * (2**bits - 1)).astype(np.int64)
    code = np.zeros(len(X), np.int64)
    for b in range(bits):
        for d in range(3):
            code |= ((g[:, d] >> b) & 1) << (3 * b + d)
    return np.argsort(code, kind="stable")


# ---------------------------------------------------------------- phase 2


def padded_batch(clouds, NA):
    import numpy as np

    X = np.zeros((len(clouds), NA, 3), np.float32)
    m = np.zeros((len(clouds), NA), np.float32)
    for b, c in enumerate(clouds):
        X[b, 1 : len(c) + 1] = c
        m[b, 1 : len(c) + 1] = 1.0
    return X, m


def check_knn_case(name, X, m, knn, dev):
    """Kernel vs plain on one padded batch (Morton keys too, and the
    ids-only entry against knn_kernel); returns a dict of the case's
    numbers."""
    import torch

    from pesto_tpu_torch.topology import _finish_topology

    Xt = torch.tensor(X, device=dev)
    mt = torch.tensor(m, device=dev)
    xc = knn.center_coords(Xt, mt)
    keys, nvalid = knn.morton_keys(xc)
    if not (torch.equal(keys, knn.morton_keys_plain(xc)) and torch.equal(nvalid.cpu(), torch.tensor(
            [int(c.sum()) for c in m], dtype=torch.int32))):
        raise AssertionError(f"knn {name}: Morton keys differ from the plain version")
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    ids_k, ok_k, dmax_k = knn.knn_kernel(xc, stats=stats)
    ids_i, ok_i = knn.knn_ids(Xt, mt)
    torch.cuda.synchronize()
    if not (torch.equal(ids_i, ids_k) and torch.equal(ok_i, ok_k)):
        raise AssertionError(f"knn {name}: the ids-only entry differs from knn_kernel")
    pairs, fill, cut_rows, cuts = stats.tolist()
    digest = hashlib.sha256(ids_k.cpu().numpy().tobytes() + ok_k.cpu().numpy().tobytes()).hexdigest()
    ids_p, ok_p, dmax_p = knn.knn_plain(xc)
    if not torch.equal(ok_k, ok_p):
        raise AssertionError(f"knn {name}: ok masks differ")
    rel = ((dmax_k - dmax_p).abs() / dmax_p.clamp_min(1e-30)).max().item()
    if rel > 1e-6:
        raise AssertionError(f"knn {name}: Dmax rel deviation {rel}")

    # rows whose ids differ must be fp32 ties of the Gram form: at every
    # slot the two chosen atoms' exact squared distances agree within the
    # rounding of sq_i + sq_j - 2 x_i.x_j
    bad = (ids_k != ids_p).any(dim=-1)
    n_rows = int(bad.sum())
    if n_rows:
        b, r = bad.nonzero(as_tuple=True)
        x64 = xc[..., :3].double()
        ci = x64[b, r]
        dk = ((x64[b[:, None], ids_k[b, r].long()] - ci[:, None]) ** 2).sum(-1)
        dp = ((x64[b[:, None], ids_p[b, r].long()] - ci[:, None]) ** 2).sum(-1)
        sq_max = (xc[..., 3].clamp_min(0).amax(dim=1)).double()[b]
        tol = 8 * 1.2e-7 * (xc[b, r, 3].double().clamp_min(0) + sq_max) + 1e-6
        dev_rows = ((dk - dp).abs() - tol[:, None]).amax(dim=1)
        if (dev_rows > 0).any():
            raise AssertionError(f"knn {name}: {int((dev_rows > 0).sum())} rows differ beyond a tie")

    _, d_k, _ = _finish_topology(Xt, ids_k, ok_k, dmax_k)
    _, d_p, _ = _finish_topology(Xt, ids_p, ok_p, dmax_p)
    dmax_dev = (d_k - d_p).abs().max().item()
    # the main path's entry (ids only) and the one with the Dmax pass
    ms = cuda_time_ms(lambda: knn.knn_kernel(xc, dmax=False), reps=5, warmup=1)
    dmax_ms = cuda_time_ms(lambda: knn.knn_kernel(xc), reps=5, warmup=1)
    dev_ms, split = device_ms(lambda: knn.knn_kernel(xc, dmax=False), reps=5)
    plain_ms = cuda_time_ms(lambda: knn.knn_plain(xc), reps=1, warmup=1)
    n2 = float((m.sum(1) ** 2).sum())
    rows = X.shape[0] * X.shape[1]
    log(f"knn {name}: B={X.shape[0]} NA={X.shape[1]} tie-rows={n_rows} "
        f"max|D_kernel-D_plain|={dmax_dev:.3g} Dmax rel={rel:.3g} "
        f"kernel {ms:.4f} ms (with Dmax {dmax_ms:.4f} ms; device {dev_ms:.4f} ms: "
        + ", ".join(f"{short_name(k)} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f") plain {plain_ms:.3f} ms; pairs evaluated {pairs} = {pairs / n2:.4f} of n^2; "
        f"largest buffer fill {fill} of {knn.SLOTS}, rows cut {cut_rows} ({cuts} cuts); bound "
        f"{bound(8 * pairs, rows * (16 + 64 * 5))['bound_ms']:.5f} ms (evaluated pairs), "
        f"{bound(8 * n2, rows * (16 + 64 * 5))['bound_ms']:.5f} ms (all pairs); "
        f"sha256 of ids and ok {digest[:16]}")
    return dict(dev=dmax_dev, ms=ms, plain_ms=plain_ms, pairs=pairs, n2=n2, rows=rows)


def phase_knn(dev):
    import numpy as np

    from pesto_tpu_torch.io import read_pdb
    from pesto_tpu_torch.ops import knn
    from pesto_tpu_torch.synthetic import random_structure_arrays, random_structure_record

    def cloud(n, seed, sort=True):
        # protein density (synthetic._cloud); file order unless sorted
        X = random_structure_arrays(n_atoms=n, n_res=max(n // 8, 4), seed=seed)[0]
        return X[morton_order(X)] if sort else X

    dup = cloud(700, 11).copy()
    dup[10] = dup[500]
    rng = np.random.RandomState(3)
    golden = read_pdb(GOLDEN)["xyz"]
    synth = random_structure_record(n_atoms=8191, n_res=1024, seed=1)["xyz"]
    cases = [
        ("sorted 900@1024", [cloud(900, 7)], 1024),
        ("unsorted 800@1024", [(rng.rand(800, 3) * 25).astype(np.float32)], 1024),
        ("far duplicate 700@1024", [dup], 1024),
        ("n<=k 50@640", [cloud(50, 3)], 640),
        ("batch 4@8192", [cloud(n, s, sort=False) for s, n in enumerate((8191, 7000, 6000, 5000))], 8192),
        ("1OL5 golden @4096", [golden], 4096),
        ("main path 8191@8192", [synth], 8192),
        ("mega 30000@32768", [cloud(30000, 5)], 32768),
        ("file-order 32767@32768", [cloud(32767, 5, sort=False)], 32768),
        ("file-order 131071@131072", [cloud(131071, 9, sort=False)], 131072),
    ]
    worst = 0.0
    timing = {}
    for name, clouds, NA in cases:
        X, m = padded_batch(clouds, NA)
        case = check_knn_case(name, X, m, knn, dev)
        worst = max(worst, case["dev"])
        timing[name] = case
    return worst, timing


# ---------------------------------------------------------------- phase 3


def edge_cost(N, nn, dt_bytes=4, S=32, Nh=2):
    """(FLOP, bytes) the layer needs: the three edge-MLP products with their
    block-diagonal structure, the per-atom first-layer term, the value
    sums; each input read once and each output written once."""
    mlp = 2 * (4 * S * 4 * S + 6 * S * S + S * 12 + 4 * S * S)
    values = 2 * Nh * S + 3 * Nh * S * 4
    flops = N * nn * (mlp + values) + N * 2 * (2 * S) * (4 * S)
    weights = (6 * S + 1) * 4 * S + 4 * S + 4 * S * 4 * S + 4 * S + 4 * S * 76 + 76
    nbytes = (N * (4 * S + nn + 3 * nn + 12 + 4 * Nh * S) + weights) * dt_bytes + N * nn * 4
    return flops, nbytes


def edge_inputs(N, nn, dt, dev, seed):
    """Seeded inputs at the main path's widths (S=32, Nh=2, Nk=3)."""
    import torch

    S = 32
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    r = torch.nn.functional.normalize(rn(N, nn, 3), dim=-1)
    vals = dict(
        qp=rn(N, 4 * S), ids=torch.randint(0, N, (N, nn), generator=g, dtype=torch.int32),
        d=torch.rand(N, nn, generator=g) * 8, r=r, nq=rn(N, 12),
        K0=rn(6 * S + 1, 4 * S, scale=1 / 14), B0=rn(4 * S, scale=0.1),
        K1=torch.block_diag(rn(S, S), rn(S, S), rn(2 * S, 2 * S)) / 8, B1=rn(4 * S, scale=0.1),
        K2=torch.block_diag(rn(S, 3), rn(S, 9), rn(2 * S, 2 * S)) / 8, B2=rn(76, scale=0.1),
    )
    return [v.to(dev) if v.dtype == torch.int32 else v.to(dev, dt).contiguous() for v in vals.values()]


def phase_edge(dev):
    import torch

    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.ops import edge_attention as ea

    for line in _build.build_logs.get("edge_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"edge_attention ptxas: {line.strip()}")
    knn_ids = main_path_inputs(dev)[0].reshape(8192, 64)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = {}
    for nn in (8, 16, 32, 64):
        for N in (8192, 1000):
            for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
                args = edge_inputs(N, nn, dt, dev, seed=nn * 7 + N)
                zq, zp = ea.edge_attention_kernel(*args)
                torch.cuda.synchronize()
                pq, pp = ea.edge_attention_plain(*args)
                err = 0.0
                for a, b in ((zq, pq), (zp, pp)):
                    a, b = a.float(), b.float()
                    excess = ((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs()).max().item()
                    if excess > 0 or not torch.isfinite(a).all():
                        raise AssertionError(f"edge nn={nn} N={N} {dt}: beyond tolerance by {excess}")
                    err = max(err, (a - b).abs().max().item())
                worst[dt] = max(worst[dt], err)
                line = f"edge nn={nn} N={N} {str(dt)[6:]}: max abs err {err:.3g}"
                if N == 8192:
                    ms = cuda_time_ms(lambda: ea.edge_attention_kernel(*args))
                    knn_args = [args[0], knn_ids[:, :nn].contiguous(), *args[2:]]
                    knn_ms = cuda_time_ms(lambda: ea.edge_attention_kernel(*knn_args))
                    pms = cuda_time_ms(lambda: ea.edge_attention_plain(*args), reps=3, warmup=1)
                    bf16 = dt == torch.bfloat16
                    flops, nbytes = edge_cost(N, nn, 2 if bf16 else 4)
                    # the products run on the tensor cores: bf16 operands at
                    # the bf16 peak; fp32 as three TF32 products (3xTF32) at
                    # the TF32 peak, beside all of it on the CUDA cores
                    if bf16:
                        lim = bound(flops, nbytes, PEAK_BF16_FLOPS)
                        extra = ""
                    else:
                        lim = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
                        cores = bound(flops, nbytes, PEAK_FP32_FLOPS)
                        extra = f", CUDA-core bound {cores['bound_ms']:.4f} ms ({cores['bound_by']})"
                    timing[(nn, dt)] = (ms, pms, lim)
                    line += (f" kernel {ms:.4f} ms (kNN ids {knn_ms:.4f} ms) plain {pms:.3f} ms "
                             f"({flops / ms / 1e9:.2f} TFLOP/s) bound {lim['bound_ms']:.4f} ms "
                             f"({lim['bound_by']}{', 3xTF32 on the tensor cores' if not bf16 else ''})"
                             f"{extra}")
                log(line)
    return worst, timing


# ---------------------------------------------------------------- phase 4


def check_outputs(structure, probs, out_dir, base):
    """Write and read back the five _i{k}.pdb files."""
    import numpy as np

    from pesto_tpu_torch.io import read_pdb, save_pdb
    from pesto_tpu_torch.structure import encode_bfactor, split_by_chain

    if not (np.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1):
        raise AssertionError(f"{base}: probabilities not finite in [0, 1]")
    for k in range(probs.shape[1]):
        path = os.path.join(out_dir, f"{base}_i{k}.pdb")
        encoded = encode_bfactor(dict(structure), probs[:, k])
        save_pdb(split_by_chain(encoded), path)
        back = read_pdb(path)
        if back["xyz"].shape[0] != structure["xyz"].shape[0]:
            raise AssertionError(f"{path}: {back['xyz'].shape[0]} atoms written")
        if np.abs(back["bfactor"] - encoded["bfactor"]).max() > 0.005 + 1e-6:
            raise AssertionError(f"{path}: B-factors do not read back")
    return probs.shape[1]


def time_path(pred, path, n_atoms, reps=3):
    """Warm host-clock split of predict_pdb_file into read + clean (host),
    pad + kNN, forward + sigmoid (each stage ends in a synchronise), then
    one forward under torch.profiler: the device's busy time and the
    operations that take most of it. Returns the stage means in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pesto_tpu_torch.batching import encode_and_pad
    from pesto_tpu_torch.io import read_structure
    from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure

    name = os.path.basename(path)
    pred.predict_pdb_file(path)  # warm
    torch.cuda.synchronize()
    stages = {"read_clean": 0.0, "pad_knn": 0.0, "forward_sigmoid": 0.0}
    for _ in range(reps):
        t0 = time.perf_counter()
        structure = concatenate_chains(preprocess_structure(read_structure(path)))
        t1 = time.perf_counter()
        ps = encode_and_pad(structure, feature_flags=pred.cfg.feature_flags,
                            device=pred.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pred.probabilities(ps)
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k] += 1e3 * dt / reps
    total = sum(stages.values())
    log(f"warm end to end {name}: {total:.2f} ms/structure, {n_atoms / total * 1e3:.0f} atoms/s "
        f"(read+clean {stages['read_clean']:.2f}, pad+kNN {stages['pad_knn']:.2f}, "
        f"forward+sigmoid {stages['forward_sigmoid']:.2f} ms)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.logits(ps)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_ops += 1
    busy = sum(by_name.values())
    log(f"profiled forward {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall:.3f}), {n_ops} device operations; top device time:")
    for op, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {ms:8.3f} ms  {op[:90]}")
    stages.update(total=total, forward_wall=wall, device_busy=busy, device_ops=n_ops)
    return stages


def phase_main(dev, tmp):
    import numpy as np
    import torch

    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.io import save_pdb
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.ops.edge_attention import edge_attention_kernel
    from pesto_tpu_torch.ops.knn import knn_kernel
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.structure import split_by_chain
    from pesto_tpu_torch.synthetic import random_structure_record

    cfg = get_config("i_v4_1")
    sd = init_state_dict(cfg, seed=0)
    pred = Predictor(cfg, sd, device=dev)
    n_layers = len(cfg.layers)

    synth = random_structure_record(n_atoms=8191, n_res=1024, seed=1)
    synth_path = os.path.join(tmp, "synth8191.pdb")
    save_pdb(split_by_chain(synth), synth_path)
    paths = [GOLDEN, synth_path]

    knn_kernel.launches = 0
    edge_attention_kernel.launches = 0
    results = [pred.predict_pdb_file(p) for p in paths]
    torch.cuda.synchronize()
    launches = {"knn": knn_kernel.launches, "edge": edge_attention_kernel.launches}
    log(f"main path launches: knn {launches['knn']} (expect {len(paths)}), "
        f"edge {launches['edge']} (expect {n_layers * len(paths)})")
    if launches != {"knn": len(paths), "edge": n_layers * len(paths)}:
        raise AssertionError(f"main path launch counts {launches}")

    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    for path, (structure, probs) in zip(paths, results):
        base = os.path.basename(path).split(".")[0]
        n = check_outputs(structure, probs, out_dir, base)
        log(f"{base}: {structure['xyz'].shape[0]} atoms, {probs.shape[0]} residues, "
            f"{n} _i*.pdb files written and read back")

    timings = {}
    for path, (structure, _) in zip(paths, results):
        timings[os.path.basename(path)] = time_path(pred, path, structure["xyz"].shape[0])

    # the same weights through the plain versions on the CPU, fp32
    pred_cpu = Predictor(cfg, sd, device="cpu")
    t0 = time.perf_counter()
    _, probs_cpu = pred_cpu.predict_pdb_file(GOLDEN)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(results[0][1] - probs_cpu).max())
    log(f"1OL5 probabilities GPU kernels vs CPU plain: max abs diff {err:.3g} "
        f"(atol {PROB_ATOL}); CPU run {cpu_s:.1f} s")
    if not err <= PROB_ATOL:
        raise AssertionError(f"1OL5 GPU vs CPU probabilities differ by {err}")
    return launches, err, timings


# ---------------------------------------------------------------- phase 5

MOSAIC_CU = "pesto_tpu_torch/csrc/mosaic_repros.cu"
GATHER_CU = "pesto_tpu_torch/csrc/exp_gather.cu"
OFF_PATH = {  # kernel: (source, the TPU kernel it replaces)
    "scale_add": (MOSAIC_CU, "docs/mosaic_repros.py:56"),
    "rowmax_mul": (MOSAIC_CU, "docs/mosaic_repros.py:87"),
    "carry_and": (MOSAIC_CU, "docs/mosaic_repros.py:109"),
    "bitcast_first": (MOSAIC_CU, "docs/mosaic_repros.py:147"),
    "bisect_mask": (MOSAIC_CU, "docs/mosaic_repros.py:178"),
    "take_lanes": (GATHER_CU, "scripts/exp_gather.py:145"),
    "take_rows": (GATHER_CU, "scripts/exp_gather.py:164"),
}
# -0.0, +inf, -inf, a NaN with a payload, a denormal, 1.0
SPECIAL_BITS = (0x80000000, 0x7F800000, 0xFF800000, 0x7FC12345, 0x00012345, 0x3F800000)


def max_abs_err(a, b):
    """Largest |a - b| over entries that differ (a NaN equals any NaN)."""
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, 0.0, (a - b).abs()).max().item()


def main_path_inputs(dev):
    """The 8192 x 64 neighbour ids of the synthetic 8191-atom structure
    (bucket 8192) as one [1, 8192*64] row, and its [8192, 8192] squared
    distances in the kNN kernel's Gram form."""
    import torch

    from pesto_tpu_torch.ops import knn
    from pesto_tpu_torch.synthetic import random_structure_record

    synth = random_structure_record(n_atoms=8191, n_res=1024, seed=1)["xyz"]
    X, m = padded_batch([synth], 8192)
    Xt, mt = torch.tensor(X, device=dev), torch.tensor(m, device=dev)
    ids = knn.knn_topk(Xt, mt)[0].reshape(1, -1).contiguous()
    xc = knn.center_coords(Xt, mt)[0]
    sq = xc[:, 3].clamp_min(0.0)
    dsq = (sq[:, None] + sq[None, :] - 2.0 * (xc[:, :3] @ xc[:, :3].T)).clamp_min(0.0)
    return ids, dsq.contiguous()


def phase_off_path(dev):
    """Every variant of the seven kernels against its plain version, bit for
    bit; one timed case per kernel for the kernels line (others logged).
    Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}."""
    import torch

    from pesto_tpu_torch.ops import exp_gather as eg
    from pesto_tpu_torch.ops import mosaic_repros as mr
    from pesto_tpu_torch.scripts import mosaic_repros as script

    gen = torch.Generator().manual_seed(0)
    checks = [v for case in script.CASES.values() for v in case(dev, gen)]
    for n in (0, 3):
        checks += script.case_i1carry(dev, gen, n=n)
    for bits in SPECIAL_BITS:
        checks += script.case_bitcast0(dev, gen, first_bits=bits)
    # ids of -1, of the width / row count (128) and the int32 extremes give NaN
    idx_out = torch.randint(0, 128, (8, 128), generator=gen, dtype=torch.int32)
    idx_out[:, 0::5], idx_out[:, 1::7] = -1, 128
    idx_out[:, 2], idx_out[:, 3] = 2**31 - 1, -2**31
    tab_l, tab_r = torch.rand((8, 128), generator=gen).to(dev), torch.rand((128, 128), generator=gen).to(dev)
    idx_out = idx_out.to(dev)
    checks += [
        ("take_lanes", "[8,128] ids with some out of range", lambda: eg.take_lanes(tab_l, idx_out),
         lambda: eg.take_lanes_plain(tab_l, idx_out)),
        ("take_rows", "[128,128] by ids with some out of range", lambda: eg.take_rows(tab_r, idx_out),
         lambda: eg.take_rows_plain(tab_r, idx_out)),
    ]
    errs = {}
    for name, label, run, plain in checks:
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        if not mr.same_bits(out, ref):
            raise AssertionError(f"{name} ({label}): kernel and plain version differ")
        errs[name] = max(errs.get(name, 0.0), max_abs_err(out, ref))
        log(f"{name} {label}: bit for bit equal to the plain version")

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4096, 1280), generator=g, device=dev)
    one = torch.ones_like(x)
    xb = torch.randn((256, 128), generator=g, device=dev)
    xb[5, 17] = float("nan")
    xb16 = xb.bfloat16()
    xcar = torch.rand((8, 128), generator=g, device=dev) * 3.5 - 0.5
    n8 = torch.tensor([8], dtype=torch.int32, device=dev)
    x1 = torch.randn((1, 128), generator=g, device=dev)
    d_small = script.bisecting_rows(gen, (256, 512)).to(dev)
    tab8 = torch.rand((8, 128), generator=g, device=dev)
    idx8 = torch.randint(0, 128, (8, 128), generator=g, device=dev, dtype=torch.int32)
    idx8_long = idx8.long()
    tab128 = torch.rand((128, 128), generator=g, device=dev)
    tab_main = torch.rand((8192, 128), generator=g, device=dev)
    ids_main, dsq_main = main_path_inputs(dev)
    L = ids_main.shape[1]

    # (kernel, shape label, in the kernels line, kernel call, plain call,
    #  library call or None, fp32 operations, bytes in + out)
    timed = [
        ("scale_add", "[4096,1280] f32, 48 KB tile", True, lambda: mr.scale_add(x),
         lambda: mr.scale_add_plain(x), lambda: torch.add(one, x, alpha=2.0),
         2 * x.numel(), 8 * x.numel()),
        ("scale_add", "[4096,1280] f32, 227 KB tile", False, lambda: mr.scale_add(x, raised=True),
         lambda: mr.scale_add_plain(x), None, 2 * x.numel(), 8 * x.numel()),
        ("rowmax_mul", "[256,128] bf16", True, lambda: mr.rowmax_mul(xb16),
         lambda: mr.rowmax_mul_plain(xb16), None, 2 * xb.numel(), 4 * xb.numel()),
        ("rowmax_mul", "[256,128] f32", False, lambda: mr.rowmax_mul(xb),
         lambda: mr.rowmax_mul_plain(xb), None, 2 * xb.numel(), 8 * xb.numel()),
        ("carry_and", "[8,128] f32, n=8, i32 carry", True, lambda: mr.carry_and(xcar, n8),
         lambda: mr.carry_and_plain(xcar, n8), None, 17 * 128, xcar.numel() * 4 + 4 + 128 * 4),
        ("carry_and", "[8,128] f32, n=8, bool carry", False,
         lambda: mr.carry_and(xcar, n8, as_bool=True), lambda: mr.carry_and_plain(xcar, n8), None,
         17 * 128, xcar.numel() * 4 + 4 + 128 * 4),
        ("bitcast_first", "[1,128] f32, rank 1", True, lambda: mr.bitcast_first(x1),
         lambda: mr.bitcast_first_plain(x1), None, 0, 4 + 128 * 4),
        ("bitcast_first", "[1,128] f32, rank 0", False, lambda: mr.bitcast_first(x1, rank=0),
         lambda: mr.bitcast_first_plain(x1), None, 0, 4 + 128 * 4),
        ("bisect_mask", "[256,512] f32 (script shape)", False, lambda: mr.bisect_mask(d_small),
         lambda: mr.bisect_mask_plain(d_small), None, 33 * d_small.numel(), 5 * d_small.numel()),
        ("bisect_mask", "[8192,8192] f32 squared distances of synth8191 (main path)", True,
         lambda: mr.bisect_mask(dsq_main), lambda: mr.bisect_mask_plain(dsq_main), None,
         33 * dsq_main.numel(), 5 * dsq_main.numel()),
        ("take_lanes", "[8,128] f32 by [8,128] ids", True, lambda: eg.take_lanes(tab8, idx8),
         lambda: eg.take_lanes_plain(tab8, idx8), lambda: torch.gather(tab8, 1, idx8_long),
         0, 4 * (tab8.numel() + 2 * idx8.numel())),
        ("take_rows", "[128,128] f32 by idx[0] of [8,128] (script shape)", False,
         lambda: eg.take_rows(tab128, idx8), lambda: eg.take_rows_plain(tab128, idx8),
         lambda: torch.index_select(tab128, 0, idx8[0]), 0, 4 * (128 * 128 + 128 + 128 * 128)),
        ("take_rows", f"[8192,128] f32 by the {L} neighbour ids of synth8191 (main path)", True,
         lambda: eg.take_rows(tab_main, ids_main), lambda: eg.take_rows_plain(tab_main, ids_main),
         lambda: torch.index_select(tab_main, 0, ids_main[0]), 0,
         4 * (tab_main.numel() + L + L * 128)),
    ]
    counts = mr.bisect_mask(dsq_main).sum(dim=1).float()
    log(f"bisect_mask on the main path's squared distances: {counts.min().item():.0f}-"
        f"{counts.max().item():.0f} entries per row under the threshold (mean {counts.mean().item():.1f})")
    stats = {}
    for name, label, in_line, run, plain, library, flops, nbytes in timed:
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        if not mr.same_bits(out, ref):
            raise AssertionError(f"{name} ({label}): kernel and plain version differ")
        err = max(errs.get(name, 0.0), max_abs_err(out, ref))
        ms = cuda_time_ms(run, reps=20)
        pms = cuda_time_ms(plain, reps=5, warmup=1)
        lms = cuda_time_ms(library, reps=20) if library else None
        # device time beside the event-loop time, which also holds the
        # host's launch path when the kernel is short
        dms = device_ms(run)[0]
        ldms = device_ms(library)[0] if library else None
        lim = bound(flops, nbytes)
        log(f"{name} {label}: kernel {ms:.4f} ms (device {dms:.4f} ms), plain {pms:.4f} ms, library "
            f"{'none' if lms is None else f'{lms:.4f} ms (device {ldms:.4f} ms)'}, bound "
            f"{lim['bound_ms']:.5f} ms ({lim['bound_by']})")
        if in_line:
            stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **lim, "library_ms": lms}
    return stats


def run_scripts():
    """Run both experiment scripts on the card; returns {kernel: launches}
    from the JSON line each prints last."""
    launches = {}
    for argv in (["pesto_tpu_torch.scripts.mosaic_repros"], ["pesto_tpu_torch.scripts.exp_gather", "all"]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        for line in r.stdout.strip().splitlines():
            log(f"  | {line}")
        log(f"{' '.join(argv)}: exit {r.returncode} in {time.perf_counter() - t0:.1f} s")
        if r.returncode != 0:
            raise AssertionError(f"{' '.join(argv)} exited {r.returncode}:\n{r.stderr[-4000:]}")
        counted = json.loads(r.stdout.strip().splitlines()[-1])["launches"]
        launches.update({k.removesuffix("_kernel"): v for k, v in counted.items()})
    missing = [k for k in OFF_PATH if not launches.get(k)]
    if missing:
        raise AssertionError(f"the scripts launched no {missing} kernel")
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from pesto_tpu_torch.device import resolve_device
        from pesto_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: pesto_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    log(f"card: {card}")

    log(f"build: {_build.build_all():.1f} s (all four sources, nvcc in parallel)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    knn_dev, knn_t = phase_knn(dev)
    edge_err, edge_t = phase_edge(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, prob_err, e2e = phase_main(dev, tmp)
    log(f"1OL5 GPU-vs-CPU probability deviation {prob_err:.3g}")
    off_path = phase_off_path(dev)
    script_launches = run_scripts()

    knn_main = knn_t["main path 8191@8192"]
    e_ms, e_pms, e_bound = edge_t[(64, torch.float32)]
    kernels = [
        {
            "name": "knn_top64", "route": "cuda", "source": "pesto_tpu_torch/csrc/knn.cu",
            "replaces": "pesto_tpu/ops/knn_pallas.py:177", "launches": launches["knn"],
            "max_abs_err": knn_dev, "ms": knn_main["ms"], "plain_ms": knn_main["plain_ms"],
            # 8 fp32 operations per pair the kernel evaluates (dot 5, Gram
            # 3); 16 B in and 64 x (4 B id + 1 B ok) out per row
            **bound(8 * knn_main["pairs"], knn_main["rows"] * (16 + 64 * 5)), "library_ms": None,
        },
        {
            "name": "edge_attention", "route": "cuda",
            "source": "pesto_tpu_torch/csrc/edge_attention.cu",
            "replaces": "pesto_tpu/ops/geometric_pallas.py:257", "launches": launches["edge"],
            "max_abs_err": edge_err[torch.float32], "ms": e_ms, "plain_ms": e_pms,
            **e_bound, "library_ms": None,
        },
    ]
    kernels += [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": script_launches[name], **off_path[name]}
        for name, (source, replaces) in OFF_PATH.items()
    ]
    log("kernel shapes: knn_top64 at the 8191-atom structure (NA=8192), the ids-only entry "
        "of the main path, bound from the pairs it evaluated; "
        "edge_attention fp32 at N=8192, nn=64 (bound: 3xTF32 on the tensor cores); "
        "bisect_mask and take_rows at the "
        "main path's shapes, the other off-path kernels at their scripts' shapes; "
        "off-path launches are those of the two scripts' runs")
    log(f"end to end ms/structure: {json.dumps(e2e)}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
