#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`pesto_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and when the package is
not beside this file). Phases, each of which fails the run on error:

  0. the card's name and power limit (nvidia-smi);
  1. build the five CUDA sources of pesto_tpu_torch/csrc (one nvcc each, in
     parallel);
  2. the kNN kernel against its plain version on the card: ids equal except
     on rows where the swapped neighbours' squared distances tie within
     fp32 rounding of the Gram form, ok equal; Dmax to rtol 1e-6; its
     Morton keys equal to their plain version and the ids-only entry
     (`knn_ids`, the main path's) equal to `knn_kernel`; per case the
     tie rows, the kernel's time (ids only, and with the Dmax pass), the
     host's us per call of the ids-only entry, its device time by kernel,
     the share of pairs it evaluated, the largest fill of a row's
     candidate buffer and the rows whose buffer was cut, and the bound
     from the evaluated pairs beside the all-pairs bound;
     up to random clouds at protein density in file order at 32768 and
     131072 atoms;
  3. the edge-attention kernel against its plain version on the card at
     nn in {8,16,32,64}, N=8192 and a ragged N: fp32 atol 5e-5 / rtol 1e-4,
     bf16 atol 5e-2 / rtol 5e-2; its warm time at N=8192 on uniform random
     ids and on the main path's own ids (the kNN of the synthetic 8191-atom
     structure, first nn columns) and the host's us per call, beside its
     bounds (fp32: on the CUDA cores, and as 3xTF32 on the tensor cores,
     the kernel's scheme); the edge library's ptxas line (registers,
     shared memory, spills). Then the backward kernel
     (csrc/edge_attention_bwd.cu) against its plain version
     (edge_attention_backward_plain) and against autograd of the plain
     forward, every gradient (qp's whole table, d, r, nq, the six weights),
     at nn in {8,16,32,64}, N=8192 and 1000, on a 4096-row shard at row0
     4096 of a 16384-row table, and on a batch of 4 x 2048 rows whose last
     600 rows per structure gather their block's row 0 with zero
     gradients: fp32 per-tensor relative L2 <= 1e-4 (floored as
     TRAIN_GRAD_RTOL), bf16 per tensor no more than twice the plain bf16
     backward's own error against the fp32 backward of the same inputs;
     at N=8192, nn=64 its time (CUDA events), device time by kernel, the
     host's us per call, the plain recompute and gradient's time, TFLOP/s
     and bounds; its ptxas line;
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
     branches (for bisect_mask also the adversarial rows of every kind at
     widths 1, 63, 64, 65, 511, 512, 8191, 30000 and SHARED_RAISED // 4,
     and at a base 4 bytes past alignment), and its warm time at the scripts' shapes and, for the
     bisection and the row take, at the main path's (8192 atoms, 64
     neighbours), and for the lane take also at the kNN select's
     (scripts/exp_gather.py:122), by CUDA events over a loop of 100
     launches (the host's launch path included; kernel and library call
     in turns), as the host's us per call (a loop timed on the host clock,
     synchronised after it) and as device time under torch.profiler, as
     for the library call beside it; then both scripts run in subprocesses,
     `python -m pesto_tpu_torch.scripts.mosaic_repros` (every case) and
     `... .exp_gather all`, which must exit 0 and report the launches of
     their kernels (each script sets its counters to 0 when it starts);
  6. training at full width: i_v4_1 (32 layers, seeded random weights) on an
     in-memory dataset of eight seeded synthetic structures (ids from the
     kNN kernel, seeded labels; H5Dataset's items) through the trainer's
     own BucketedLoader (16384 atoms per batch, compact codes),
     create_train_state, train and eval steps, run_eval, AsyncCheckpointer
     and restore_checkpoint. Once the model is on the card, one epoch of the
     loader with 2 forked workers equals the prefetch thread's. For fp32
     and for bf16 compute on fp32 master weights: 12 train steps (two
     epochs, then more on one batch of each shape until B=2x8192 and
     B=4x4096 have 6 each), each with a finite loss, a finite gradient on
     every parameter, and global_step and pos_ratios moved, and each timed
     by CUDA events, split into forward, backward and optimizer (the median
     of the 5 after each shape's first), with the peak memory; the edge
     launch counter set to 0 before and read after (32 per train step, the
     kernel inside its autograd Function; 32 per eval batch); a checkpoint
     saved while training goes on and restored into a fresh state bit for
     bit (fp32); the edge backward kernel's launches (32 per train step
     inside EdgeAttentionFunction.backward, none per eval batch); one step
     under torch.profiler: the edge kernels' share of the forward's device
     time, and the edge backward kernel's device time and share of the
     backward's (no edge_attention_recompute range may be left). Then one fp32 step on a 1OL5 batch (bucket 4096) on the
     card and on the CPU (plain versions) from the same weights: the loss
     to rtol 1e-4 and each gradient to a relative L2 error of 1e-3. The
     phase logs the seconds each of its parts took;
  7. serving at full width: i_v4_1 (32 layers, seeded random weights).
     Predictor.predict_batch on 1OL5 and seeded synthetic records of 700,
     3000, 6000 and 8191 atoms (buckets 1024, 4096 and 8192, B > 1 per
     chunk), with the launch counters set to 0 just before and read just
     after (1 kNN and 32 edge launches per chunk) and the peak memory; each
     output held against that structure's own predict_structure on the card
     at atol 1e-4. Both kernels against their plain versions on the
     inputs of each chunk of that check (B=3 x 1024, B=4 x 4096, B=4 x
     8192) and of a B=8 x 4096 chunk: the kNN as in phase 2, the edge
     kernel on the inputs that the chunk's forward gives it at the first
     layer of each nn (N = B x NA rows, each structure's ids in its own
     row block), fp32 at atol 5e-5 / rtol 1e-4. predict_pdb_files on a
     folder of 1OL5, an unreadable file and a 140000-atom PDB (past the
     largest bucket): (None, None) and a ReadError, None and a SizeError,
     1OL5 intact. The headline, 12 seeded 8191-atom structures through
     predict_batch, warm, fp32 and bf16 (bf16 within 5e-2 of fp32):
     atoms/s as the median of 3 runs, the stage_ms split, the peak memory
     and one chunk under torch.profiler (device busy share), beside
     predict_structure on the same structures one at a time; the edge
     kernel against its plain version on a bf16 headline chunk's own
     inputs (B=4 x 8192, atol 5e-2 / rtol 5e-2). Then make_server on port
     0 with the server's defaults
     (max batch 32, 10 ms, 2 batcher threads): 32 concurrent clients POST
     1OL5 and three synthetic PDBs, as JSON and as ?format=pdb, each body
     made distinct so that the response cache does not answer; each JSON
     response within 1e-5 of a direct Predictor call, each annotated PDB's
     B-factors within one 0.01 quantum; requests/s, p50 and p99 latency,
     /v1/stats and the launches while serving (32 edge per kNN); the
     server shuts down and its batcher threads join.

  8. the dataset slice at full width, on seeded PDBs written with the port's
     writer: a 2-chain complex of 2 x 3000 atoms with an ATP ligand and MG
     and ZN ions, a 4-chain complex of 7800 atoms, a 8400-atom file (over
     max_num_atoms, skipped) and an unreadable file (ReadError). Per file,
     the host part once, then the contacts and the per-subunit kNN on the
     card (the kNN launch counter set to 0 just before and read just after:
     one launch per subunit with a contact) and on the CPU: the packed items
     equal, ids_topk rows apart only where neighbours tie, a contact on one
     side only within 1e-5 A of r_thr; the kNN kernel against knn_plain on
     each such subunit's own unpadded shape (NA = n + 1, down to the
     one-atom ions). The build's files/s and packed atoms/s through
     build_items with no device given (the card) and 0 and 4 host workers,
     with its kNN launches, split into host, contacts, kNN and pack ms by
     the host clock with a synchronise at each edge. Then the built items
     as H5Dataset would load them (its label mapping over an in-memory
     stand-in for the HDF5 groups), scored by evaluate_items and
     confidence_rows with i_v4_1 on a Predictor given no device (32 edge
     launches per forward), and one item's probabilities against the
     CPU's at atol 1e-4.

  9. trajectories and the dimer model at full width, i_v4_1 (32 layers,
     seeded random weights). predict_trajectory on 64 frames of phase 4's
     8191-atom structure (a seeded random walk of 0.1 A rms per frame),
     chunk 8, fp32, with the launch counters set to 0 just before and read
     just after (1 kNN for the frozen topology, 32 edge per chunk: 256);
     frame 0 against predict_structure on the card at atol 1e-4; frames/s
     and atoms/s as the median of 3 warm calls, the peak memory, one call
     of one chunk under torch.profiler (device busy share), and a bf16
     chunk within 5e-2 of fp32. The edge kernel against its plain version
     on one chunk's own inputs (B=8 x 8192 rows, every frame's block the
     same ids), fp32 at atol 5e-5 / rtol 1e-4. Then, while the md CLI (16
     frames of chain A of phase 8's 2 x 3000-atom complex, --ref that
     complex) and the complexes CLI (that complex, no --out) run on the card
     in subprocesses: predict_trajectory on 4 frames of 1OL5, chunk 2, card
     against CPU at atol 1e-4, and evaluate_complex on the complex, card
     against CPU at atol 1e-4, both with i_v4_0 (16 layers of the same
     width: the CPU's plain 32-layer forward would take most of the
     phase); the cross model (CrossPestoModel at i_v4_1 width) on
     the complex's chains A and B, forward and backward by CUDA events
     (median of 3), 64 edge launches per forward and 64 edge backward
     launches per backward, a finite gradient on every
     parameter, and on a 2 x 1000-atom pair its logits against the CPU's at
     atol 1e-4 and each gradient at a relative L2 error of 1e-3; the traj/
     toolkit (superpose, rmsd, contacts_per_frame, fnat, irmsd,
     contacts_distribution) on the 64 frames with the structure's two
     halves as subunits, its ms per call, and on the first 8 frames card
     against CPU (coordinates atol 1e-4 A, counts equal); shrake_rupley on
     4 frames (ms per frame) and on a 1000-atom 1OL5 crop card against CPU
     (per atom within one test point's area, total within 0.1%). Both CLIs
     must exit 0: md writes 16 rows of finite AUCs, complexes prints a
     summary of 2 chains. The phase logs the seconds of each part.

 10. the multi-device paths at full width, i_v4_1 (32 layers, seeded random
     weights), on the one card unless the machine has two. The edge kernel
     with a table and an offset: shards of 16384 and 8192 rows at every
     offset of a 32768-row table (ids over the whole table, nn=64), fp32
     and bf16, against its plain version (FP32_TOL, BF16_TOL), each shard's
     rows held bit for bit to the whole table's launch, an 8192-row shard
     timed. Data-parallel training in ranks spawned by
     `parallel.launch.spawn_ranks` (the kernels already built): NCCL at
     world size 1, two gloo ranks sharing cuda:0, and NCCL over two cards
     where there are two; each rank builds its rows of phase 6's batches
     with the trainer's loader (process_count = world size) and takes 3
     checked steps per dtype (fp32, bf16 on fp32 masters), timed by CUDA
     events, with the kNN launches (none: the items carry their ids), the
     edge launches (32 per step) and edge backward launches (32 per
     step), the collectives (3 per
     step) and the peak memory per rank; the loss and every parameter after
     3 steps held against one process on the same global batches (fp32:
     loss rtol 1e-5, parameters atol 2e-5 / rtol 1e-4, the biases with an
     exact gradient of 0 to Adam's bound; bf16: DP_BF16_*). DP x SP
     training (`parallel.make_sp_train_step`, one process): the same 3
     global batches per dtype on a [2, 2] mesh of cuda:0 (and [1, 2] over
     two cards where there are two), each batch's structures over the
     mesh's rows and its atoms over its columns, held against the same
     one-process run at the same tolerances; per step the step ms by CUDA
     events, the edge and edge backward launches (one per cell per layer:
     128 on [2, 2]),
     the offsets they ran at (each column's block of the shard-major
     table), no kNN, the collectives (72 on [2, 2]), every replica equal to
     the master, and the peak memory; one more fp32 step under
     torch.profiler (device ms and kernels of its forward and backward,
     beside phase 6's profile of one device); then the batched 2-D forward
     (`make_sp_forward(batch_axis=True)`) on a B=2 x 8192 batch against
     the one-device logits at atol 1e-4, its ms beside the one device's,
     and each under torch.profiler (wall, device busy, device ops).
     Data-parallel serving: phase 7's 12 x 8191-atom headline through predict_batch over
     a mesh of [cuda:0, cuda:0] (and of two cards) against one device at
     1e-5, one kNN and 32 edge launches per device part, no collective,
     atoms/s of 3 calls. One structure sharded: predict_structure_sp on a
     32767-atom record 2 and 4 ways on cuda:0 against predict_structure at
     atol 1e-4, with its ms, peak memory, 1 kNN and 32 x shards edge
     launches; then a 65535-atom record 2 ways, its peak memory (an
     out-of-memory there is logged with the dense pool's computed size and
     does not fail the run). Times with two ranks or shards on one card
     measure correctness and overhead, not scaling.

 11. the applications at full width, i_v4_1 (32 layers, seeded random
     weights). The native PDB parser (built with g++ before phase 2; its
     build failing fails the run) against the Python reader, every field
     and dtype equal, on 1OL5, a synthetic 8191-atom PDB, its gzip and a
     file of two MODELs with altlocs, and each reader's parse ms (median
     of 5); time_path's read_clean stage on the 8191-atom file with the
     native parser and with PESTO_NO_NATIVE=1. The profiling CLI on 1OL5
     and that file (its CSV rows printed; 2 kNN and 4 x 32 edge
     launches). The PPI benchmark CLI on a golden triple built from 1OL5
     (1OL5_A_i0.pdb, its truth _T with fixed labels, a method's _M), on
     the card and with --device cpu: probabilities within 1e-5, AUCs
     within 1e-4. masif_benchmark.bench_ours on a benchmark directory
     written here (1OL5, a PLY mesh of its atoms with fixed interface
     labels, the transient list), fp32 card against CPU, AUCs within
     1e-4, and bf16 on the card. The interfaceome's predict core over 12
     records, 11 synthetic of 1024-8191 atoms and one past the largest
     bucket (skipped), against predict_batch on the same records (1e-6),
     then its cluster and analyze cores (pack and aggregate need h5py and
     run only where it imports). Predictor.export_compiled on the buckets
     8192x1024 (fp32) and 4096x512 (bf16), written, reloaded: every
     layer's edge attention one operator node, 32 counted edge launches
     per call, the logits against Predictor.logits within 1e-6 (fp32) and
     1e-2 (bf16), and the exported forward's ms beside the eager one's by
     CUDA events; the fp32 eager forward as shipped (the launcher called
     directly) and routed through the operator, in turns, and the host's
     us per call of each at 256 atoms. Each of these paths runs
     with the launch counters set to 0 just before and read just after.

The kernels line gives the launches of the inference path (phase 4) and of
the scripts (phase 5), for the edge backward kernel those of phase 6's
fp32 train steps and, per phase, of every training path (6, 9, 10), and for the two main-path kernels those of phase
10's and phase 11's paths (`launches_phase10`, among them the DP x SP
steps' and the batched 2-D forward's, `launches_phase11`);
phases 6-9 log their own. Its max_abs_err
for the two main-path kernels is the largest of phases 2-3, of phase 7's
fp32 chunks and phase 9's MD chunk, for the edge kernel of phase 10's
fp32 shards and, for the kNN, of phase 8's subunits. Its host_us is the
host's us per call (phases 2, 3 and 5). The last three lines are the
card's name and power limit, one JSON object with each kernel's numbers,
and {"ok": true, "device": {...}}.
"""

import hashlib
import json
import re
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


def host_us(fn, calls=1000, repeats=5):
    """The host's us per call of fn(): the median over `repeats` loops of
    `calls` calls, each loop timed on the host clock, which stops before
    the one synchronisation that ends it (the launch path's own cost, while
    the card keeps up)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    loops = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        loops.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(loops)


def short_name(kernel):
    """A CUDA kernel's name without its namespace and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[: min([len(name)] + [i for i in (name.find("<"), name.find("(")) if i >= 0])]
    return (name.split() or [name])[-1].split("::")[-1][:40]


def demangled(sym):
    """The last name of a mangled nested symbol (_ZN <len><name> ..., the
    namespaces dropped), with <fp32> or <bf16> for a float or bfloat16
    template argument."""
    rest, name = sym[3:] if sym.startswith("_ZN") else "", sym
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    if rest.startswith("If"):
        name += "<fp32>"
    elif rest.startswith("I13__nv_bfloat16"):
        name += "<bf16>"
    return name


def ptxas_report(log_text):
    """One line per kernel of a `-Xptxas -v` log: its name (without
    namespace, its template argument kept), registers, spill stores and
    loads in bytes."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = demangled(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name, spill = None, ""
    return out


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


def check_knn_case(name, X, m, knn, dev, timed=True):
    """Kernel vs plain on one padded batch (Morton keys too, and the
    ids-only entry against knn_kernel); returns a dict of the case's
    numbers, its timings only where timed."""
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
    if not timed:
        return dict(dev=dmax_dev, tie_rows=n_rows)
    # the main path's entry (ids only) and the one with the Dmax pass
    ms = cuda_time_ms(lambda: knn.knn_kernel(xc, dmax=False), reps=5, warmup=1)
    dmax_ms = cuda_time_ms(lambda: knn.knn_kernel(xc), reps=5, warmup=1)
    dev_ms, split = device_ms(lambda: knn.knn_kernel(xc, dmax=False), reps=5)
    host = host_us(lambda: knn.knn_kernel(xc, dmax=False), calls=50)
    plain_ms = cuda_time_ms(lambda: knn.knn_plain(xc), reps=1, warmup=1)
    n2 = float((m.sum(1) ** 2).sum())
    rows = X.shape[0] * X.shape[1]
    log(f"knn {name}: B={X.shape[0]} NA={X.shape[1]} tie-rows={n_rows} "
        f"max|D_kernel-D_plain|={dmax_dev:.3g} Dmax rel={rel:.3g} "
        f"kernel {ms:.4f} ms (with Dmax {dmax_ms:.4f} ms; host {host:.2f} us per call; "
        f"device {dev_ms:.4f} ms: "
        + ", ".join(f"{short_name(k)} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f") plain {plain_ms:.3f} ms; pairs evaluated {pairs} = {pairs / n2:.4f} of n^2; "
        f"largest buffer fill {fill} of {knn.SLOTS}, rows cut {cut_rows} ({cuts} cuts); bound "
        f"{bound(8 * pairs, rows * (16 + 64 * 5))['bound_ms']:.5f} ms (evaluated pairs), "
        f"{bound(8 * n2, rows * (16 + 64 * 5))['bound_ms']:.5f} ms (all pairs); "
        f"sha256 of ids and ok {digest[:16]}")
    return dict(dev=dmax_dev, ms=ms, plain_ms=plain_ms, pairs=pairs, n2=n2, rows=rows, host_us=host)


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
                    host = host_us(lambda: ea.edge_attention_kernel(*args), calls=100)
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
                    timing[(nn, dt)] = (ms, pms, lim, host)
                    line += (f" kernel {ms:.4f} ms (kNN ids {knn_ms:.4f} ms; host {host:.2f} us per "
                             f"call) plain {pms:.3f} ms "
                             f"({flops / ms / 1e9:.2f} TFLOP/s) bound {lim['bound_ms']:.4f} ms "
                             f"({lim['bound_by']}{', 3xTF32 on the tensor cores' if not bf16 else ''})"
                             f"{extra}")
                log(line)
    return worst, timing


EDGE_BWD_RTOL = 1e-4  # fp32: per gradient tensor, relative L2, floored as TRAIN_GRAD_RTOL's formula
# bf16: per gradient tensor, the kernel's relative L2 error against the fp32
# backward of the same bf16 inputs at most this times the plain bf16
# backward's own error against it
EDGE_BWD_BF16_RATIO = 2.0
EDGE_BWD_SHARD = (16384, 4096, 4096)  # table rows, shard rows, row0 of the table-and-offset case
EDGE_BWD_SINK = (4, 2048, 600)  # structures, rows each, padding rows each (gathering their block's row 0)


def edge_bwd_cost(N, nn, dt_bytes=4, S=32, Nh=2):
    """(FLOP, bytes) of the layer's VJP: the forward rebuilt and its three
    edge-MLP products twice more (transposed, and against their inputs),
    3x the forward's FLOP; the forward's inputs and both output gradients
    read once, the table's, the per-edge, nq's and the weights' gradients
    written once."""
    flops, nbytes = edge_cost(N, nn, dt_bytes, S, Nh)
    weights = (6 * S + 1) * 4 * S + 4 * S + 4 * S * 4 * S + 4 * S + 4 * S * 76 + 76
    return 3 * flops, nbytes + (N * (4 * S + 4 * nn + 12) + weights) * dt_bytes


def rel_errors(got, want):
    """Per tensor |got - want| / max(|want|, 1e-4 max_t |want_t|), L2 (None
    where want is None)."""
    floor = 1e-4 * max(float(w.double().norm()) for w in want if w is not None)
    return [None if w is None else float((g.double() - w.double()).norm()) / max(float(w.double().norm()), floor)
            for g, w in zip(got, want)]


def edge_bwd_case(N, nn, dt, dev, seed, n_table=None, blocks=None):
    """Seeded inputs of the backward: edge_inputs' (with n_table, a table of
    that many rows whose ids name any row; the caller picks the atoms'
    row0), and both output gradients. With blocks = (B, NA, pad), B
    structures of NA rows: each row's ids stay in its block, and each
    structure's last pad rows gather the block's row 0 in every slot and
    get zero gradients, as padding rows do."""
    import torch

    args = edge_inputs(n_table or N, nn, dt, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    if n_table:
        args[1] = torch.randint(0, n_table, (N, nn), generator=g, dtype=torch.int32).to(dev)
        args[2:5] = [a[:N].contiguous() for a in args[2:5]]
    gzq, gzp = torch.randn(N, 64, generator=g), torch.randn(N, 192, generator=g)
    if blocks:
        B, NA, pad = blocks
        ids = args[1].reshape(B, NA, nn) % NA + torch.arange(B, device=dev, dtype=torch.int32)[:, None, None] * NA
        ids[:, NA - pad :] = (torch.arange(B, device=dev, dtype=torch.int32) * NA)[:, None, None]
        args[1] = ids.reshape(N, nn).contiguous()
        for z in (gzq, gzp):
            z.reshape(B, NA, -1)[:, NA - pad :] = 0
    return args, gzq.to(dev, dt), gzp.to(dev, dt)


def autograd_backward(args, gzq, gzp, row0=0):
    """The gradients of edge_attention_plain by autograd (qp, d, r, nq and
    the weights; K1's and K2's on their diagonal blocks)."""
    import torch

    from pesto_tpu_torch.ops import edge_attention as ea

    leaves = [a.detach().requires_grad_() if a.is_floating_point() else a for a in args]
    with torch.enable_grad():
        outs = ea.edge_attention_plain(*leaves, row0=row0)
        grads = list(torch.autograd.grad(outs, [a for a in leaves if a.requires_grad], (gzq, gzp)))
    m1, m2 = ea.block_masks(grads[6], grads[8])
    grads[6], grads[8] = grads[6] * m1, grads[8] * m2
    return grads


def phase_edge_bwd(dev):
    """The backward kernel against its plain version and autograd of the
    plain forward (phase 3's second half). Returns (worst errors {dtype:
    max relative L2}, the largest fp32 |kernel - plain|, timing at N=8192,
    nn=64 {dtype: dict})."""
    import torch

    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.ops import edge_attention as ea

    for line in ptxas_report(_build.build_logs.get("edge_attention_bwd", "")):
        log(f"edge_attention_bwd ptxas: {line}")
    n_table, n_shard, row0 = EDGE_BWD_SHARD
    B, NA, pad = EDGE_BWD_SINK
    cases = [(f"nn={nn} N={N}", dict(N=N, nn=nn), 0) for nn in (8, 16, 32, 64) for N in (8192, 1000)]
    cases += [(f"nn={nn} table {n_table} row0 {row0}", dict(N=n_shard, nn=nn, n_table=n_table), row0)
              for nn in (16, 64)]
    cases += [(f"nn={nn} sink B={B}x{NA} pad {pad}", dict(N=B * NA, nn=nn, blocks=EDGE_BWD_SINK), 0)
              for nn in (8, 64)]
    worst, timing, abs_err = {}, {}, 0.0
    for dt in (torch.float32, torch.bfloat16):
        for i, (name, kw, r0) in enumerate(cases):
            args, gzq, gzp = edge_bwd_case(dt=dt, dev=dev, seed=31 * i + 7, **kw)
            got = ea.edge_attention_backward_kernel(*args, gzq, gzp, row0=r0)
            again = ea.edge_attention_backward_kernel(*args, gzq, gzp, row0=r0)
            torch.cuda.synchronize()
            if not all(torch.isfinite(x).all() for x in got):
                raise AssertionError(f"edge backward {name} {dt}: not finite")
            # the weight gradients are the blocks' partials summed in a fixed
            # order: two launches give the same bits (the table's gradient,
            # summed by atomics, may not)
            if not all(torch.equal(x, y) for x, y in zip(got[4:], again[4:])):
                raise AssertionError(f"edge backward {name} {dt}: dK0 .. dB2 differ between two launches")
            del again
            if dt == torch.float32:
                plain = ea.edge_attention_backward_plain(*args, gzq, gzp, row0=r0)
                e_plain = rel_errors(got, plain)
                abs_err = max(abs_err, *(float((x - y).abs().max()) for x, y in zip(got, plain)))
                e_auto = rel_errors(got, autograd_backward(args, gzq, gzp, r0))
                bad = max(e_plain + e_auto) > EDGE_BWD_RTOL
                detail = f"vs plain {max(e_plain):.3g}, vs autograd {max(e_auto):.3g} (tol {EDGE_BWD_RTOL})"
                err = max(e_plain + e_auto)
            else:
                up = [a.float() if a.is_floating_point() else a for a in args]
                ref = ea.edge_attention_backward_plain(*up, gzq.float(), gzp.float(), row0=r0)
                e_kern = rel_errors(got, ref)
                e_plain = rel_errors(ea.edge_attention_backward_plain(*args, gzq, gzp, row0=r0), ref)
                e_auto = rel_errors(autograd_backward(args, gzq, gzp, r0), ref)
                ratio = [k / p if p else (0.0 if k == 0 else float("inf")) for k, p in zip(e_kern, e_plain)]
                bad = max(ratio) > EDGE_BWD_BF16_RATIO
                detail = (f"against fp32: kernel {max(e_kern):.3g}, plain bf16 {max(e_plain):.3g}, autograd "
                          f"bf16 {max(e_auto):.3g}; worst ratio kernel / plain {max(ratio):.3g} "
                          f"({ea.GRAD_NAMES[ratio.index(max(ratio))]}; tol {EDGE_BWD_BF16_RATIO})")
                err = max(e_kern)
            worst[dt] = max(worst.get(dt, 0.0), err)
            line = (f"edge backward {name} {str(dt)[6:]}: per-tensor rel L2 {detail}; dK0 .. dB2 bit-identical "
                    "over two launches")
            if name == "nn=64 N=8192":
                N = 8192
                f = lambda: ea.edge_attention_backward_kernel(*args, gzq, gzp)  # noqa: E731
                ms = cuda_time_ms(f, reps=10, warmup=2)
                dms, by = device_ms(f, reps=5, warmup=1)
                host = host_us(f, calls=20, repeats=3)
                pms = cuda_time_ms(lambda: autograd_backward(args, gzq, gzp), reps=3, warmup=1)
                bf16 = dt == torch.bfloat16
                flops, nbytes = edge_bwd_cost(N, 64, 2 if bf16 else 4)
                if bf16:
                    lim, extra = bound(flops, nbytes, PEAK_BF16_FLOPS), ""
                else:
                    lim = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
                    cores = bound(flops, nbytes, PEAK_FP32_FLOPS)
                    extra = f", CUDA-core bound {cores['bound_ms']:.4f} ms ({cores['bound_by']})"
                timing[dt] = dict(ms=ms, device_ms=dms, host_us=host, plain_ms=pms, bound=lim,
                                  by_kernel={short_name(k): v for k, v in by.items()})
                line += (f"; kernel {ms:.4f} ms (device {dms:.4f} ms: "
                         f"{json.dumps({short_name(k): round(v, 4) for k, v in by.items()})}; host {host:.2f} us "
                         f"per call) plain recompute + gradient {pms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s) "
                         f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}"
                         f"{', 3xTF32 on the tensor cores' if not bf16 else ''}){extra}")
            log(line)
            if bad:
                raise AssertionError(f"edge backward {name} {dt}: beyond tolerance")
    log(f"edge backward: largest |kernel - plain| over the fp32 cases {abs_err:.3g}; the weight gradients "
        f"bit-identical over two launches in all {2 * len(cases)} cases")
    return worst, abs_err, timing


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


# (width, rows) of the bisect_mask checks: the odd widths, a row that fills
# two stages, one that fills one, and the widest the wrapper takes (one
# stage and the rest through L2), each with more rows than resident blocks
BISECT_CASES = ((1, 64), (63, 64), (64, 64), (65, 64), (511, 64), (512, 64), (8191, 600),
                (30000, 300), (None, 300))


def check_bisect_rows(dev):
    """bisect_mask against bisect_mask_plain on the card, bit for bit, on
    the adversarial rows of every kind (scripts/mosaic_repros.py
    `adversarial_rows`) at each width of BISECT_CASES (None: the widest,
    SHARED_RAISED // 4), and on [300, 8192] and [300, 8191] rows whose base
    lies 4 bytes past 16-byte alignment. Returns the largest |error|."""
    import torch

    from pesto_tpu_torch.ops import mosaic_repros as mr
    from pesto_tpu_torch.scripts import mosaic_repros as script

    def rows_of(seed, rows, cols, offset=0):
        """The adversarial rows on the card, `offset` floats past the
        allocation's aligned base (a contiguous view)."""
        flat = torch.from_numpy(script.adversarial_rows(seed, rows, cols)).reshape(-1).to(dev)
        return torch.cat([flat.new_zeros(offset), flat])[offset:].view(rows, cols)

    cases = []
    for cols, rows in BISECT_CASES:
        cols = cols or mr.SHARED_RAISED // 4
        cases.append((f"[{rows},{cols}] adversarial rows", rows_of(cols, rows, cols)))
    for cols in (8192, 8191):
        cases.append((f"[300,{cols}] adversarial rows at a base 4 bytes past alignment",
                      rows_of(cols + 1, 300, cols, offset=1)))
    err = 0.0
    for label, d in cases:
        out = mr.bisect_mask(d)
        torch.cuda.synchronize()
        ref = mr.bisect_mask_plain(d)
        if not mr.same_bits(out, ref):
            bad = (out != ref).any(dim=1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"bisect_mask ({label}): kernel and plain version differ in rows {bad}")
        err = max(err, max_abs_err(out, ref))
        per_row = ref.sum(dim=1)
        log(f"bisect_mask {label} (data_ptr % 16 = {d.data_ptr() % 16}): bit for bit equal to the "
            f"plain version; {per_row.min().item()}-{per_row.max().item()} entries per row under the "
            "threshold")
    return err


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
    errs["bisect_mask"] = max(errs["bisect_mask"], check_bisect_rows(dev))

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
    # the kNN select of scripts/exp_gather.py:122: 64 of 128 candidates per row
    tab_sel = torch.rand((8192, 128), generator=g, device=dev)
    idx_sel = torch.randint(0, 128, (8192, 64), generator=g, device=dev, dtype=torch.int32)
    idx_sel_long = idx_sel.long()
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
        ("take_lanes", "[8192,128] f32 by [8192,64] ids (the kNN select, exp_gather.py:122)", False,
         lambda: eg.take_lanes(tab_sel, idx_sel), lambda: eg.take_lanes_plain(tab_sel, idx_sel),
         lambda: torch.gather(tab_sel, 1, idx_sel_long), 0, 4 * (tab_sel.numel() + 2 * idx_sel.numel())),
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
        # kernel and library in turns, each over a loop of 100 calls by
        # CUDA events (the host's launch path included when the kernel is
        # short), beside the host's us per call and the device time alone
        turns = [cuda_time_ms(f, reps=100) for f in (run, library, library, run) if f]
        ms = (turns[0] + turns[-1]) / 2
        lms = (turns[1] + turns[2]) / 2 if library else None
        pms = cuda_time_ms(plain, reps=5, warmup=1)
        calls = 100 if nbytes > 1e7 else 1000  # so that the card keeps up with the host
        hus = host_us(run, calls)
        lhus = host_us(library, calls) if library else None
        dms = device_ms(run)[0]
        ldms = device_ms(library)[0] if library else None
        lim = bound(flops, nbytes)
        log(f"{name} {label}: kernel {ms:.4f} ms (host {hus:.2f} us per call, device {dms:.4f} ms), "
            f"plain {pms:.4f} ms, library "
            f"{'none' if lms is None else f'{lms:.4f} ms (host {lhus:.2f} us, device {ldms:.4f} ms)'}"
            f", bound {lim['bound_ms']:.5f} ms ({lim['bound_by']})")
        if in_line:
            stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **lim, "library_ms": lms,
                           "host_us": hus, "device_ms": dms}
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


# ---------------------------------------------------------------- phase 6

TRAIN_LOSS_RTOL = 1e-4  # fp32 step loss, card (3xTF32 edge products) vs CPU (fp32)
TRAIN_GRAD_RTOL = 1e-3  # per tensor: |g_card - g_cpu| / max(|g_cpu|, 1e-4 max_t |g_cpu,t|), L2
EDGE_KERNELS = ("edge_attention_kernel", "atom_term_kernel")
# atoms of the eight synthetic training structures: four in the 4096-atom
# bucket, four in the 8192-atom bucket; with 16384 atoms per batch the
# loader makes one batch of 4 x 4096 and two of 2 x 8192
TRAIN_SIZES = (3000, 3500, 4000, 4095, 6500, 7000, 7600, 8191)
TRAIN_ATOMS_PER_BATCH = 16384
TRAIN_TIMED = 5  # timed steps per batch shape and dtype, after the first


class MemoryDataset:
    """H5Dataset's items, (X, raw 0-based ids, q, M, y), held in memory."""

    def __init__(self, items):
        self.items = items
        self.sizes = [[len(it[0]), it[3].shape[1]] for it in items]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def training_item(X, q, M, seed, dev):
    """(X, ids, q, M, y): the ids from the kNN kernel (0-based, as a dataset
    stores them), labels from a seed (about a fifth positive)."""
    import numpy as np
    import torch

    from pesto_tpu_torch.batching import pad_structure_arrays
    from pesto_tpu_torch.ops.knn import knn_ids

    ps = pad_structure_arrays(X, q, M)
    ids, _ = knn_ids(torch.tensor(ps.X[None], device=dev), torch.tensor(ps.atom_mask[None], device=dev))
    n = X.shape[0]
    y = (np.random.RandomState(seed).rand(M.shape[1], 5) < 0.2).astype(np.float32)
    return X, ids[0, 1 : n + 1].cpu().numpy().astype(np.int64) - 1, q, M, y


def grad_errors(a, b):
    """{name: relative L2 error of a's gradient against b's}, each floored
    at 1e-4 of b's largest gradient norm: some gradients are zero in exact
    arithmetic (a bias that every logit of a softmax shares)."""
    gb = {k: p.grad.double().cpu() for k, p in b.model.named_parameters()}
    floor = 1e-4 * max(float(g.norm()) for g in gb.values())
    return {k: float((p.grad.double().cpu() - gb[k]).norm()) / max(float(gb[k].norm()), floor)
            for k, p in a.model.named_parameters()}


def check_step(state, out, before):
    """A train step's loss is finite, every parameter has a finite
    gradient, and the step and pos_ratios moved."""
    import torch

    if not torch.isfinite(out["loss"]):
        raise AssertionError(f"train step {state.global_step}: loss {out['loss']}")
    for k, p in state.model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train step {state.global_step}: {k}.grad is "
                                 f"{'None' if p.grad is None else 'not finite'}")
    step, pos = before
    if state.global_step != step + 1 or torch.equal(state.pos_ratios, pos):
        raise AssertionError(f"train step {state.global_step}: global_step or pos_ratios did not move")


def timed_step(state, step_fn, batch):
    """One checked train step timed by CUDA events (the step's own marks):
    (state, {"forward", "backward", "optimizer", "step"} ms, loss)."""
    import torch

    events = [torch.cuda.Event(enable_timing=True)]

    def mark(name):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    before = (state.global_step, state.pos_ratios.clone())
    events[0].record()
    state, out = step_fn(state, batch, mark=mark)
    check_step(state, out, before)  # reads the loss: waits for the step
    torch.cuda.synchronize()
    ms = {name: a.elapsed_time(b) for name, a, b in zip(("forward", "backward", "optimizer"), events, events[1:])}
    ms["step"] = sum(ms.values())
    return state, ms, float(out["loss"])


def check_fork_loader(ds, reference):
    """The loader's forked workers (numpy only, forked after CUDA is in use)
    give the same batches as the prefetch thread: one epoch of each."""
    import numpy as np

    from pesto_tpu_torch.batching import FIELDS
    from pesto_tpu_torch.data.loader import BucketedLoader

    forked = BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH, compact=True, seed=0,
                            num_workers=2)
    try:
        got = list(forked)
    finally:
        forked.close()
    want = list(reference)
    same = len(got) == len(want) and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for a, b in zip(got, want) for f in FIELDS)
    log(f"loader with 2 forked workers: {len(got)} batches, {'equal' if same else 'NOT equal'} to the "
        f"prefetch thread's")
    if not same:
        raise AssertionError("the forked loader's batches differ from the prefetch thread's")


def profile_step(state, step_fn, batch):
    """One train step, its forward and backward each under torch.profiler:
    the kernels' device time, the edge kernels' share of the forward's, and
    the device time of the edge backward (the kernels inside the
    `edge_attention_backward` ranges) and its share of the backward's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    profs = {k: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
             for k in ("forward", "backward")}

    def mark(name):
        torch.cuda.synchronize()
        if name in profs:
            profs[name].stop()
        if name == "forward":
            profs["backward"].start()

    profs["forward"].start()
    step_fn(state, batch, mark=mark)
    torch.cuda.synchronize()

    span = "edge_attention_backward"

    def device_events(prof):
        """(kernels [(name, start, ms)], spans [(start, end)]): the device
        timeline; a record_function range shows there as a span."""
        ks, spans = [], []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("Activity Buffer"):
                continue
            if e.name == span:
                spans.append((e.time_range.start, e.time_range.end))
            elif not e.name.startswith("edge_attention_recompute"):
                ks.append((e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3))
            else:
                raise AssertionError(f"profiled step: a {e.name} range is left in the backward")
        return ks, spans

    fwd, _ = device_events(profs["forward"])
    bwd, spans = device_events(profs["backward"])
    fwd_ms, bwd_ms = sum(k[2] for k in fwd), sum(k[2] for k in bwd)
    edge = sum(k[2] for k in fwd if any(n in k[0] for n in EDGE_KERNELS))
    # the kernels that start inside a span ran in that range (one stream)
    inside = [k for k in bwd if any(a <= k[1] < b for a, b in spans)]
    top = {}
    for name, _, ms in bwd:
        top[short_name(name)] = top.get(short_name(name), 0.0) + ms
    by_kernel = {}
    for name, _, ms in inside:
        by_kernel[short_name(name)] = by_kernel.get(short_name(name), 0.0) + ms
    # None where the trace holds no device time: not measured
    edge_bwd = sum(k[2] for k in inside)
    return {"forward_device_ms": fwd_ms, "edge_kernel_ms": edge, "forward_kernels": len(fwd),
            "edge_share": edge / fwd_ms if fwd_ms else None, "backward_device_ms": bwd_ms,
            "backward_kernels": len(bwd), "edge_backward_ranges": len(spans),
            "edge_backward_ms": edge_bwd, "edge_backward_share": edge_bwd / bwd_ms if bwd_ms else None,
            "edge_backward_kernels": by_kernel,
            "backward_top": dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])}


def phase_train(dev, tmp):
    """Training at full width on the card: i_v4_1 (32 layers) from
    port.init_state_dict(seed=0), an in-memory dataset of eight seeded
    synthetic structures through the trainer's own loader, train and eval
    steps, checkpoint and restore. Returns its numbers."""
    import statistics

    import numpy as np
    import torch

    from pesto_tpu_torch.batching import to_device
    from pesto_tpu_torch.data.loader import BucketedLoader
    from pesto_tpu_torch.encoding import encode_features, encode_structure
    from pesto_tpu_torch.io import read_structure
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.ops.edge_attention import edge_attention_backward_kernel, edge_attention_kernel
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure
    from pesto_tpu_torch.synthetic import random_structure_arrays
    from pesto_tpu_torch.train import create_train_state, make_eval_step, make_train_step
    from pesto_tpu_torch.train.checkpoint import AsyncCheckpointer, restore_checkpoint, snapshot
    from pesto_tpu_torch.train.loop import run_eval

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - t_part[0]
        t_part[0] = now

    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    items = [training_item(*random_structure_arrays(n_atoms=n, n_res=n // 8, seed=200 + i), 300 + i, dev)
             for i, n in enumerate(TRAIN_SIZES)]
    ds = MemoryDataset(items)
    loader = BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH, compact=True, seed=0)
    plan = [(tuple(map(int, b)), len(it)) for b, it in loader._plan()]
    log(f"train data: {len(ds)} structures ({', '.join(map(str, TRAIN_SIZES))} atoms), batches "
        f"{plan} (bucket, structures)")
    train_step, eval_step = make_train_step(), make_eval_step()
    part_done("dataset (kNN ids on the card)")

    def put(b):
        return to_device(b, dev)

    results = {}
    for dtype in ("float32", "bfloat16"):
        state = create_train_state(cfg.replace(dtype=dtype), 1e-4, state_dict=sd, device=dev)
        part_done(f"{dtype} train state")
        if dtype == "float32":
            # the model is on the card: fork the loader's workers now
            check_fork_loader(ds, BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH,
                                                 compact=True, seed=0))
            part_done("forked loader check")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # two epochs through the loader, then more steps on one batch of each
        # shape until each shape has TRAIN_TIMED + 1 steps; every step is
        # checked and timed, the first of each shape is its warm-up
        edge_attention_kernel.launches = 0
        edge_attention_backward_kernel.launches = 0
        losses, times, batches = [], {}, {}
        for _epoch in range(2):
            for host_batch in loader:
                batch = put(host_batch)
                shape = tuple(batch.X.shape[:2])
                batches.setdefault(shape, batch)
                state, ms, loss = timed_step(state, train_step, batch)
                times.setdefault(shape, []).append(ms)
                losses.append(loss)
        for shape, batch in sorted(batches.items()):
            while len(times[shape]) < TRAIN_TIMED + 1:
                state, ms, loss = timed_step(state, train_step, batch)
                times[shape].append(ms)
                losses.append(loss)
        torch.cuda.synchronize()
        n_steps = len(losses)
        train_launches = edge_attention_kernel.launches
        bwd_launches = edge_attention_backward_kernel.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        part_done(f"{dtype} train steps")
        for (B, NA), runs in sorted(times.items()):
            t = {k: statistics.median(r[k] for r in runs[1:]) for k in runs[0]}
            t["peak_gib"] = peak_gib
            log(f"train step {dtype} B={B}x{NA}: {t['step']:.2f} ms (forward {t['forward']:.2f}, "
                f"backward {t['backward']:.2f}, optimizer {t['optimizer']:.2f}; median of "
                f"{len(runs) - 1} checked steps after the first, CUDA events), "
                f"{B * NA / t['step'] * 1e3:.0f} atoms/s, peak memory {peak_gib:.2f} GiB")
            results[f"{dtype} B={B}x{NA}"] = t

        edge_attention_kernel.launches = 0
        edge_attention_backward_kernel.launches = 0
        scores, n_eval = run_eval(state, loader, eval_step, put, eval_size=len(ds))
        torch.cuda.synchronize()
        eval_launches = edge_attention_kernel.launches
        eval_bwd = edge_attention_backward_kernel.launches
        n_eval_batches = len(plan)
        log(f"train {dtype}: {n_steps} steps, losses {', '.join(f'{v:.5f}' for v in losses)}; "
            f"edge launches {train_launches} (expect {n_layers * n_steps}), edge backward launches "
            f"{bwd_launches} (expect {n_layers * n_steps}: {n_layers} per train step); eval of {n_eval} "
            f"structures: loss {scores['loss']:.5f}, edge launches {eval_launches} "
            f"(expect {n_layers * n_eval_batches}), edge backward launches {eval_bwd} (expect 0); "
            f"pos_ratios {state.pos_ratios.tolist()}")
        if (train_launches != n_layers * n_steps or eval_launches != n_layers * n_eval_batches
                or bwd_launches != n_layers * n_steps or eval_bwd != 0):
            raise AssertionError(f"train {dtype}: edge launches {train_launches} / {eval_launches}, "
                                 f"backward {bwd_launches} / {eval_bwd}")
        results[f"{dtype} launches"] = {"train_steps": n_steps, "edge": train_launches,
                                        "edge_bwd": bwd_launches, "eval_edge": eval_launches,
                                        "eval_edge_bwd": eval_bwd}
        if not np.isfinite(scores["loss"]):
            raise AssertionError(f"eval {dtype}: loss {scores['loss']}")
        part_done(f"{dtype} eval")

        if dtype == "float32":
            # checkpoint round trip while training goes on
            ck_dir = os.path.join(tmp, "ckpt")
            ref = snapshot(state)
            ck = AsyncCheckpointer()
            ck.save(ck_dir, state)
            state, _, _ = timed_step(state, train_step, batches[max(batches)])
            ck.close()
            fresh = restore_checkpoint(ck_dir, create_train_state(cfg, 1e-4, seed=1, device=dev))
            back = snapshot(fresh)
            same = all(torch.equal(back["model"][k], v) for k, v in ref["model"].items())
            same &= all(torch.equal(back["optimizer"]["state"][i][k], v)
                        for i, s in ref["optimizer"]["state"].items() for k, v in s.items())
            same &= torch.equal(back["pos_ratios"], ref["pos_ratios"])
            same &= back["global_step"] == ref["global_step"]
            log(f"checkpoint round trip at step {ref['global_step']} (saved while step "
                f"{state.global_step} ran): bit for bit {'equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError("checkpoint round trip changed the state")
            del fresh, back, ref
            part_done("checkpoint round trip")

        big = max(batches, key=lambda shape: shape[1])  # B=2 x 8192
        prof = profile_step(state, train_step, batches[big])
        log(f"profiled step {dtype} B={big[0]}x{big[1]}: forward device "
            f"{prof['forward_device_ms']:.2f} ms, edge kernels {prof['edge_kernel_ms']:.2f} ms "
            f"(share {prof['edge_share']}); backward device {prof['backward_device_ms']:.2f} ms, of "
            f"which the edge backward kernel {prof['edge_backward_ms']:.2f} ms in "
            f"{prof['edge_backward_ranges']} ranges (share {prof['edge_backward_share']}; by kernel "
            f"{json.dumps(prof['edge_backward_kernels'])}); the backward's top kernels (ms): "
            f"{json.dumps(prof['backward_top'])}")
        results[f"{dtype} profile"] = prof
        del state, batches
        torch.cuda.empty_cache()
        part_done(f"{dtype} profiled step")

    # one fp32 step on a 1OL5 batch (bucket 4096), card against CPU
    s = concatenate_chains(preprocess_structure(read_structure(GOLDEN)))
    X, M = encode_structure(s)
    golden = MemoryDataset([training_item(X, encode_features(s)[0], M, 7, dev)])
    host_batch = next(iter(BucketedLoader(golden, golden.sizes, compact=True, shuffle=False)))
    steps = []
    for where in (dev, "cpu"):
        state = create_train_state(cfg, 1e-4, state_dict=sd, device=where)
        state, out = train_step(state, to_device(host_batch, where))
        steps.append((state, float(out["loss"])))
        part_done(f"1OL5 step on the {'card' if where == dev else 'CPU'}")
    (card, loss_c), (cpu, loss_p) = steps
    errs = grad_errors(card, cpu)
    worst = max(errs, key=errs.get)
    loss_err = abs(loss_c - loss_p) / abs(loss_p)
    log(f"1OL5 train step fp32, card vs CPU (plain versions): loss {loss_c:.7f} vs "
        f"{loss_p:.7f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients: worst tensor {worst} "
        f"rel L2 {errs[worst]:.3g} (tol {TRAIN_GRAD_RTOL}), median {np.median(list(errs.values())):.3g}")
    if not (loss_err <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError("1OL5 train step: card and CPU disagree beyond tolerance")
    results["grad_check"] = {"loss_rel": loss_err, "worst": worst, "worst_rel": errs[worst]}
    part_done("gradient comparison")
    log(f"phase 6 parts (s): {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    results["parts_s"] = parts
    return results


# ---------------------------------------------------------------- phase 7

# synthetic records of the batched check, (atoms, residues, copies): with
# 1OL5 (2158 atoms, bucket 4096) they fill the buckets 1024, 4096 and 8192
# with more than one structure per chunk
BATCH_MIX = ((700, 87, 3), (3000, 375, 3), (6000, 750, 2), (8191, 1024, 2))
HEADLINE = (12, 8191, 1024)  # structures, atoms, residues: bench.py's headline
HEADLINE_RUNS = 3
BF16_PROB_ATOL = 5e-2
SERVE_PROB_ATOL = 1e-5  # JSON rounds to 6 decimals
SERVE_CLIENTS = 32
SERVE_PER_CLIENT = 3
SERVE_SIZES = ((700, 87), (3000, 375), (6000, 750))  # request bodies beside 1OL5
OVER_BUCKET_ATOMS = 140000  # past the largest atom bucket, 131072


def bucket_of(rec):
    """The (atom, residue) bucket of a structure record."""
    import numpy as np

    from pesto_tpu_torch.batching import ATOM_BUCKETS, RES_BUCKETS, pick_bucket

    return (pick_bucket(len(rec["xyz"]) + 1, ATOM_BUCKETS),
            pick_bucket(len(np.unique(rec["resid"])), RES_BUCKETS))


def expected_chunks(recs, atoms_per_call=32768):
    """The chunks predict_batch makes of recs: one per `atoms_per_call //
    na` structures of a bucket (at least one)."""
    import collections

    groups = collections.Counter(bucket_of(r) for r in recs)
    return sum(-(-n // max(1, atoms_per_call // na)) for (na, _), n in groups.items()), dict(groups)


def reset_launches():
    from pesto_tpu_torch.ops.edge_attention import edge_attention_kernel
    from pesto_tpu_torch.ops.knn import knn_kernel

    knn_kernel.launches = 0
    edge_attention_kernel.launches = 0


def read_launches():
    from pesto_tpu_torch.ops.edge_attention import edge_attention_kernel
    from pesto_tpu_torch.ops.knn import knn_kernel

    return {"knn": knn_kernel.launches, "edge": edge_attention_kernel.launches}


def over_bucket_pdb(path):
    """A two-chain PDB of OVER_BUCKET_ATOMS atoms (serials and residue
    numbers restart per chain, within the PDB columns)."""
    import numpy as np

    from pesto_tpu_torch.io import save_pdb
    from pesto_tpu_torch.structure import split_by_chain
    from pesto_tpu_torch.synthetic import random_structure_record

    n = OVER_BUCKET_ATOMS
    rec = random_structure_record(n_atoms=n, n_res=n // 8, seed=9)
    half = np.arange(n) >= n // 2
    rec["chain_name"] = np.where(half, "B:0", "A:0")
    rec["resid"] = np.where(half, rec["resid"] - rec["resid"][n // 2] + 1, rec["resid"])
    save_pdb(split_by_chain(rec), path)


def encode_chunk(pred, recs):
    """recs (one bucket) encoded into one chunk on the card, as
    predict_batch encodes it: (batch, nr, (B, na, nr))."""
    from pesto_tpu_torch.batching import ATOM_BUCKETS, RES_BUCKETS, BatchEncoder, pick_bucket

    items = [pred._encode_record(r) for r in recs]
    na = pick_bucket(max(len(it[0]) for it in items) + 1, ATOM_BUCKETS)
    nr = pick_bucket(max(it[3] for it in items), RES_BUCKETS)
    enc = BatchEncoder(4)
    try:
        b = enc.encode(items, na=na, nr=nr, n_features=pred.cfg.em_n0, device=pred.device)
    finally:
        enc.close()
    return b, nr, (len(items), na, nr)


def profile_chunk(pred, recs):
    """One chunk (the records, one bucket) of the batched path under
    torch.profiler: (wall ms, device busy ms, device operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    b, nr, shape = encode_chunk(pred, recs)
    pred._knn_forward_sigmoid(b.X, b.q, b.M, b.atom_mask, nr=nr)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred._knn_forward_sigmoid(b.X, b.q, b.M, b.atom_mask, nr=nr)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    return wall, sum(kernels), len(kernels), shape


def capture_edge_inputs(run):
    """{nn: the arguments that run() gives the edge attention at the first
    layer of each nn}, cloned."""
    import importlib

    model_mod = importlib.import_module("pesto_tpu_torch.models.pesto")
    fused, inputs = model_mod.fused_edge_attention, {}

    def capture(*args, **kw):
        if args[1].shape[1] not in inputs:
            inputs[args[1].shape[1]] = tuple(a.clone() for a in args)
        return fused(*args, **kw)

    model_mod.fused_edge_attention = capture
    try:
        run()
    finally:
        model_mod.fused_edge_attention = fused
    return inputs


def check_edge_inputs(inputs, name, tol, B, na):
    """The edge kernel against its plain version on captured inputs over a
    flattened batch of B structures of na rows (each structure's ids in its
    own row block), at tol. Returns {nn: max abs err}."""
    import torch

    from pesto_tpu_torch.ops import edge_attention as ea

    errs = {}
    for nn, args in sorted(inputs.items()):
        ids = args[1].long()
        if not (ids // na == torch.arange(B * na, device=ids.device)[:, None] // na).all():
            raise AssertionError(f"edge {name} nn={nn}: an id leaves its structure's row block")
        zq, zp = ea.edge_attention_kernel(*args)
        pq, pp = ea.edge_attention_plain(*args)
        err = 0.0
        for k, p in ((zq, pq), (zp, pp)):
            k, p = k.float(), p.float()
            excess = ((k - p).abs() - tol["atol"] - tol["rtol"] * p.abs()).max().item()
            if excess > 0 or not torch.isfinite(k).all():
                raise AssertionError(f"edge {name} nn={nn} N={B * na}: beyond tolerance by {excess}")
            err = max(err, (k - p).abs().max().item())
        errs[nn] = err
    log(f"edge {name}, its own inputs at N={B * na} (B={B} x {na}): max abs err "
        + ", ".join(f"nn={nn} {e:.3g}" for nn, e in errs.items())
        + f" (atol {tol['atol']}, rtol {tol['rtol']})")
    return errs


def check_chunk_kernels(pred, recs, name):
    """Both kernels of the batched path against their plain versions on one
    chunk's own inputs (recs, one bucket): the kNN on the chunk's
    coordinates (check_knn_case), and the edge kernel on the inputs that
    the chunk's forward gives it at the first layer of each nn, over the
    flattened batch (N = B x NA rows, each structure's ids in its own row
    block), at FP32_TOL or BF16_TOL by the model's dtype. Returns (kNN
    max |D_kernel - D_plain|, {nn: edge max abs err})."""
    from pesto_tpu_torch.ops import knn

    b, nr, (B, na, _) = encode_chunk(pred, recs)
    knn_case = check_knn_case(f"{name} B={B}@{na}", b.X.cpu().numpy(), b.atom_mask.cpu().numpy(), knn,
                              pred.device)
    inputs = capture_edge_inputs(lambda: pred._knn_forward_sigmoid(b.X, b.q, b.M, b.atom_mask, nr=nr))
    tol = BF16_TOL if pred.cfg.dtype == "bfloat16" else FP32_TOL
    errs = check_edge_inputs(inputs, f"{name} ({pred.cfg.dtype})", tol, B, na)
    return knn_case["dev"], errs


def http_post(port, body, path, timeout=300):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def http_get(port, path, timeout=60):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        return conn.getresponse().read()
    finally:
        conn.close()


def phase_serve(dev, tmp):
    """Batched inference and the HTTP batching server at full width (i_v4_1,
    32 layers, seeded random weights). Returns its numbers."""
    import contextlib
    import io
    import statistics
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.io import read_structure, save_pdb
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.serve import BatchingService, _parse_body_to_structure, make_server
    from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure, split_by_chain
    from pesto_tpu_torch.synthetic import random_structure_record

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    pred = Predictor(cfg, sd, device=dev)
    res = {}

    # batched inference against one structure at a time, on the card
    golden = concatenate_chains(preprocess_structure(read_structure(GOLDEN)))
    recs = [golden] + [random_structure_record(n_atoms=n, n_res=r, seed=700 + 10 * i + c)
                       for i, (n, r, copies) in enumerate(BATCH_MIX) for c in range(copies)]
    n_chunks, groups = expected_chunks(recs)
    pred.predict_batch(recs[:1])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    batched = pred.predict_batch(recs)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"knn": n_chunks, "edge": n_layers * n_chunks}
    log(f"batched: {len(recs)} structures ({sum(len(r['xyz']) for r in recs)} atoms) in buckets "
        f"{ {f'{na}x{nr}': n for (na, nr), n in groups.items()} } -> {n_chunks} chunks in {wall * 1e3:.1f} ms; "
        f"launches knn {launches['knn']}, edge {launches['edge']} (expect {want['knn']}, {want['edge']}: "
        f"1 kNN and {n_layers} edge per chunk); peak memory {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"batched launches {launches}, expected {want}")
    errs = []
    for r, b in zip(recs, batched):
        single = pred.predict_structure(r)
        if b is None or b.shape != single.shape or not np.isfinite(b).all():
            raise AssertionError(f"batched output {None if b is None else b.shape} vs {single.shape}")
        errs.append(float(np.abs(b - single).max()))
    log(f"batched vs one at a time on the card: max abs diff {max(errs):.3g} (atol {PROB_ATOL}) over "
        f"{len(recs)} structures: " + ", ".join(f"{len(r['xyz'])} atoms {e:.3g}" for r, e in zip(recs, errs)))
    if max(errs) > PROB_ATOL:
        raise AssertionError(f"batched and one-at-a-time probabilities differ by {max(errs)}")
    res["batched"] = {"structures": len(recs), "chunks": n_chunks, "launches": launches,
                      "max_abs_err": max(errs), "ms": wall * 1e3, "peak_gib": peak}
    part_done("batched check")

    # both kernels against their plain versions at the batched path's own
    # shapes and inputs: each chunk of the check, and a server-sized B=8
    # chunk of the 4096 bucket
    by_bucket = {}
    for r in recs:
        by_bucket.setdefault(bucket_of(r), []).append(r)
    chunk_sets = [(f"chunk {na}x{nr}", rs) for (na, nr), rs in sorted(by_bucket.items())]
    chunk_sets.append(("server-sized chunk", 2 * next(rs for (na, _), rs in by_bucket.items() if na == 4096)))
    res["chunk_kernels"] = {"knn_dev": 0.0, "edge_fp32": 0.0}
    for name, rs in chunk_sets:
        knn_dev, edge_errs = check_chunk_kernels(pred, rs, name)
        res["chunk_kernels"]["knn_dev"] = max(res["chunk_kernels"]["knn_dev"], knn_dev)
        res["chunk_kernels"]["edge_fp32"] = max(res["chunk_kernels"]["edge_fp32"], *edge_errs.values())
    part_done("chunk kernels")

    # the folder path: an unreadable file and an over-bucket structure give
    # None, the rest is predicted
    folder = os.path.join(tmp, "folder")
    os.makedirs(folder)
    paths = [os.path.join(folder, f) for f in ("1OL5_A.pdb", "broken.pdb", "huge.pdb")]
    with open(GOLDEN) as src, open(paths[0], "w") as dst:
        dst.write(src.read())
    with open(paths[1], "w") as f:
        f.write("this is not a pdb file\n")
    over_bucket_pdb(paths[2])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        structs, probs = pred.predict_pdb_files(paths)
    err = err.getvalue()
    folder_ok = (structs[1] is None and probs[1] is None and structs[2] is not None
                 and len(structs[2]["xyz"]) == OVER_BUCKET_ATOMS and probs[2] is None
                 and probs[0] is not None and "ReadError" in err and "SizeError" in err)
    folder_err = float(np.abs(probs[0] - batched[0]).max()) if probs[0] is not None else float("nan")
    log(f"folder path: 1OL5 {None if probs[0] is None else probs[0].shape} (vs the batched run: "
        f"{folder_err:.3g}), unreadable -> {structs[1]}, {probs[1]}; {len(structs[2]['xyz'])}-atom "
        f"structure -> {probs[2]}; stderr: {' | '.join(err.strip().splitlines())[:300]}")
    if not folder_ok or not folder_err <= PROB_ATOL:
        raise AssertionError("the folder path did not degrade per item")
    part_done("folder path")

    # headline: 12 structures of 8191 atoms through predict_batch, warm
    n_big, n_atoms, n_res = HEADLINE
    big = [random_structure_record(n_atoms=n_atoms, n_res=n_res, seed=800 + i) for i in range(n_big)]
    total = n_big * n_atoms
    heads, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        p = pred if dtype == "float32" else Predictor(cfg.replace(dtype=dtype), sd, device=dev)
        p.predict_batch(big)  # warm
        torch.cuda.synchronize()
        before = dict(p.stage_ms)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(HEADLINE_RUNS):
            t0 = time.perf_counter()
            outs[dtype] = p.predict_batch(big)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = {k: (p.stage_ms[k] - before[k]) / HEADLINE_RUNS for k in before if k != "batch_calls"}
        wall, busy, n_ops, shape = profile_chunk(p, big[:4])
        if dtype == "bfloat16":
            _, edge_errs = check_chunk_kernels(p, big[:4], "headline chunk")
            res["chunk_kernels"]["edge_bf16"] = max(edge_errs.values())
        heads[dtype] = {"atoms_per_s": total / statistics.median(times), "runs_ms": [t * 1e3 for t in times],
                        "stage_ms": stages, "peak_gib": peak, "chunk": shape, "chunk_wall_ms": wall,
                        "chunk_device_ms": busy, "chunk_busy_share": busy / wall, "chunk_device_ops": n_ops}
        log(f"headline {dtype}: {n_big} x {n_atoms} atoms through predict_batch: "
            f"{heads[dtype]['atoms_per_s']:.0f} atoms/s (median of {HEADLINE_RUNS}: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms); stage ms per call "
            f"{json.dumps({k: round(v, 2) for k, v in stages.items()})}; peak memory {peak:.2f} GiB; "
            f"one chunk B={shape[0]} {shape[1]}x{shape[2]} profiled: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (share {busy / wall:.3f}), {n_ops} device operations")
        del p
    bf16_err = max(float(np.abs(a - b).max()) for a, b in zip(outs["bfloat16"], outs["float32"]))
    log(f"headline bf16 vs fp32 probabilities: max abs diff {bf16_err:.3g} (atol {BF16_PROB_ATOL})")
    if not bf16_err <= BF16_PROB_ATOL:
        raise AssertionError(f"bf16 and fp32 probabilities differ by {bf16_err}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in big:
        pred.predict_structure(r)
    single = time.perf_counter() - t0
    heads["one_at_a_time_atoms_per_s"] = total / single
    heads["bf16_max_abs_err"] = bf16_err
    log(f"headline one at a time (predict_structure, fp32, warm): {total / single:.0f} atoms/s "
        f"({single * 1e3 / n_big:.1f} ms per structure); batched fp32 is "
        f"{heads['float32']['atoms_per_s'] * single / total:.2f}x that")
    res["headline"] = heads
    torch.cuda.empty_cache()
    part_done("headline")

    # the server: 32 concurrent clients, JSON and annotated-PDB responses
    bodies = [open(GOLDEN, "rb").read()]
    for i, (n, r) in enumerate(SERVE_SIZES):
        path = os.path.join(tmp, f"req{n}.pdb")
        save_pdb(split_by_chain(random_structure_record(n_atoms=n, n_res=r, seed=900 + i)), path)
        bodies.append(open(path, "rb").read())
    parsed = [_parse_body_to_structure(b, "", "", 64 << 20) for b in bodies]
    service = BatchingService(pred, max_batch=32, max_wait_ms=10.0, n_threads=2)
    srv = make_server(service, host="127.0.0.1", port=0, model_name="i_v4_1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def client(c):
        out = []
        for j in range(SERVE_PER_CLIENT):
            which, k = (c + j) % len(bodies), (c + j) % cfg.dm_n2
            fmt = "json" if (c + j) % 2 == 0 else "pdb"
            path = "/v1/predict" if fmt == "json" else f"/v1/predict?format=pdb&class={k}"
            # a distinct body per request, so that the response cache does
            # not answer for the device
            body = f"REMARK 999 client {c} request {j}\n".encode() + bodies[which]
            t0 = time.perf_counter()
            status, data = http_post(srv.server_port, body, path)
            out.append((status, time.perf_counter() - t0, which, fmt, k, data))
        return out

    try:
        reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            results = [r for rs in pool.map(client, range(SERVE_CLIENTS), timeout=900) for r in rs]
        serve_wall = time.perf_counter() - t0
        serve_launches = read_launches()
        stats = json.loads(http_get(srv.server_port, "/v1/stats"))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        joined = service.close(timeout_s=60)
    if thread.is_alive() or not joined:
        raise AssertionError("the server or its batcher threads did not stop")
    part_done("server load")

    direct = pred.predict_batch(parsed)
    worst_json = worst_pdb = 0.0
    for status, _, which, fmt, k, data in results:
        if status != 200:
            raise AssertionError(f"server answered {status}: {data[:200]}")
        if fmt == "json":
            got = np.array(json.loads(data)["probabilities"], dtype=np.float64)
            if got.shape != direct[which].shape:
                raise AssertionError(f"server response shape {got.shape} vs {direct[which].shape}")
            worst_json = max(worst_json, float(np.abs(got - direct[which]).max()))
        else:
            lines = [ln for ln in data.decode().splitlines() if ln.startswith(("ATOM", "HETATM"))]
            bf = np.array([float(ln[60:66]) for ln in lines])
            s = parsed[which]
            _, rid = np.unique(s["resid"], return_inverse=True)
            if len(lines) != len(s["xyz"]):
                raise AssertionError(f"annotated PDB has {len(lines)} atoms, expected {len(s['xyz'])}")
            # two decimals written: one quantum at most where a rounding tie flips
            worst_pdb = max(worst_pdb, float(np.abs(bf - direct[which][rid, k]).max()))
    lat = np.array([r[1] for r in results]) * 1e3
    res["serve"] = {
        "requests": len(results), "clients": SERVE_CLIENTS, "wall_s": serve_wall,
        "requests_per_s": len(results) / serve_wall, "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)), "mean_batch_size": stats.get("mean_batch_size"),
        "launches": serve_launches, "json_max_abs_err": worst_json, "pdb_max_abs_err": worst_pdb,
        "stats": stats,
    }
    log(f"server: {len(results)} requests from {SERVE_CLIENTS} clients in {serve_wall:.2f} s: "
        f"{res['serve']['requests_per_s']:.2f} requests/s, p50 {res['serve']['p50_ms']:.1f} ms, p99 "
        f"{res['serve']['p99_ms']:.1f} ms, mean batch {stats.get('mean_batch_size')}; launches while "
        f"serving knn {serve_launches['knn']}, edge {serve_launches['edge']}; JSON vs direct max abs diff "
        f"{worst_json:.3g} (atol {SERVE_PROB_ATOL}), PDB B-factors vs direct {worst_pdb:.3g} (0.01 "
        f"quantum); /v1/stats {json.dumps(stats)}")
    if worst_json > SERVE_PROB_ATOL or worst_pdb > 0.01 + 1e-9:
        raise AssertionError("server responses differ from the direct Predictor")
    if not (serve_launches["knn"] >= stats["batches"] > 0
            and serve_launches["edge"] == n_layers * serve_launches["knn"]):
        raise AssertionError(f"launches while serving {serve_launches}, {stats['batches']} batches")
    part_done("server check")
    log(f"phase 7 parts (s): {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    res["parts_s"] = parts
    return res


# ---------------------------------------------------------------- phase 8

# the build's inputs: (file, chains, atoms per chain, with the ATP ligand and
# the MG and ZN ions, seed); "broken.pdb1" is written unreadable
BUILD_FILES = (("1cpx.pdb1", 2, 3000, True, 11), ("2cpx.pdb1", 4, 1950, False, 12),
               ("3big.pdb1", 2, 4200, False, 13))
BUILD_COPIES = 4  # each input file this many times in the timed builds
BUILD_WORKERS = (0, 4)
CONTACT_EDGE = 1e-5  # a contact one side has and the other lacks lies this close to r_thr


def complex_pdb(path, n_chains, atoms_per_chain, hets, seed):
    """A seeded multi-chain complex written with the port's writer: each
    chain a box of atoms at protein density (0.1 per cubic A), Morton-sorted
    into residues of 8 atoms, the boxes side by side on a 2 x 2 grid so that
    neighbours touch over a face; with hets, an ATP ligand (31 atoms) and
    MG and ZN ions on the face between chains A and B."""
    import numpy as np

    from pesto_tpu_torch.encoding import categ_to_resnames
    from pesto_tpu_torch.io import save_pdb

    rng = np.random.RandomState(seed)
    L = (atoms_per_chain / 0.1) ** (1.0 / 3.0)
    names = np.array(["N", "CA", "C", "O", "CB", "CG", "CD", "NE"])
    prot = np.array(categ_to_resnames["protein"])
    su = {}
    for c in range(n_chains):
        X = rng.rand(atoms_per_chain, 3) * L + np.array([(c % 2) * L, (c // 2) * L, 0.0])
        X = X[morton_order(X)].astype(np.float32)
        resid = np.arange(atoms_per_chain) // 8 + 1
        name = names[np.arange(atoms_per_chain) % 8]
        su["ABCD"[c]] = {
            "xyz": X, "name": name, "element": np.array([n[0] for n in name]),
            "resname": prot[rng.randint(0, len(prot), resid[-1])][resid - 1], "resid": resid,
            "het_flag": np.array(["A"] * atoms_per_chain),
        }
    if hets:
        face = np.array([L, L / 2, L / 2])
        xyz = np.concatenate([face[None] + [0.0, -3.0, 0.0], face[None] + [0.0, 3.0, 0.0],
                              face + [0.5, 6.0, 2.0] + 4.0 * rng.rand(31, 3)]).astype(np.float32)
        su["H"] = {
            "xyz": xyz, "name": np.array(["MG", "ZN"] + [f"C{i}" for i in range(31)]),
            "element": np.array(["Mg", "Zn"] + ["C"] * 20 + ["O"] * 8 + ["P"] * 3),
            "resname": np.array(["MG", "ZN"] + ["ATP"] * 31), "resid": np.array([1, 2] + [3] * 31),
            "het_flag": np.array(["H"] * 33),
        }
    save_pdb(su, path)
    return sum(len(s["xyz"]) for s in su.values())


def contact_pairs(contacts):
    """{(cid_i, cid_j, atom_i, atom_j)} of one direction of each pair."""
    return {(a, b, int(i), int(j)) for a in contacts for b in contacts[a] if a < b
            for i, j in contacts[a][b]["ids"]}


def same_items(name, got, want):
    """Packed build items of one file, card against CPU: every array and
    attribute equal except ids_topk rows that tie (check_knn_case holds the
    kernel's ids to that rule on the same shapes); returns the rows of
    ids_topk that differ."""
    import numpy as np

    if (got is None) != (want is None):
        raise AssertionError(f"build {name}: the card and the CPU disagree on skipping the file")
    if got is None:
        return 0
    if got[:2] != want[:2] or list(got[2]) != list(want[2]) or list(got[3]) != list(want[3]):
        raise AssertionError(f"build {name}: keys differ")
    rows = 0
    parts = [(f"structure {c}", got[2][c], want[2][c]) for c in got[2]]
    parts += [(f"contact {a}/{b}", got[3][a][b], want[3][a][b]) for a in got[3] for b in got[3][a]]
    for what, (gd, ga), (wd, wa) in parts:
        if list(gd) != list(wd) or list(ga) != list(wa):
            raise AssertionError(f"build {name} {what}: fields differ")
        for k in gd:
            g, w = np.asarray(gd[k]), np.asarray(wd[k])
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"build {name} {what} {k}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
            if k == "ids_topk":
                rows += int((g != w).any(axis=1).sum())
            elif not np.array_equal(g, w):
                raise AssertionError(f"build {name} {what} {k} differs")
        for k in ga:
            if not np.array_equal(np.asarray(ga[k]), np.asarray(wa[k])):
                raise AssertionError(f"build {name} {what} attribute {k} differs")
    return rows


class MemGroup(dict):
    """An in-memory stand-in for an h5py group: datasets by key, and attrs."""

    def __init__(self, data, attrs):
        super().__init__(data)
        self.attrs = attrs


def dataset_items(built, feature_flags):
    """The (X, ids_topk, q, M, y) items that H5Dataset would load from a
    file of the built entries, with the trainer's default types (protein
    ligand, five receptor classes) through the dataset's own label mapping;
    for the subunits of 48 residues or more (setup_dataset's min_num_res)."""
    import numpy as np

    from pesto_tpu_torch.data.build import MOLECULE_IDS
    from pesto_tpu_torch.data.dataset import load_interface_labels
    from pesto_tpu_torch.data.h5 import load_sparse_mask
    from pesto_tpu_torch.train.loop import TrainConfig

    tc = TrainConfig()
    t0 = np.where(np.isin(MOLECULE_IDS, list(tc.l_types)))[0]
    t1_l = [np.where(np.isin(MOLECULE_IDS, list(rt)))[0] for rt in tc.r_types]
    ftrs = [fn for fn, ff in zip(["qe", "qr", "qn"], feature_flags) if ff]
    items = []
    for _, _, structures, contacts in built:
        for cid, (data, attrs) in structures.items():
            g = MemGroup(data, attrs)
            M = load_sparse_mask(g, "M")
            if M.shape[1] < tc.min_num_res:
                continue
            q = np.concatenate([load_sparse_mask(g, fn) for fn in ftrs], axis=1)
            y = np.zeros((M.shape[1], len(t1_l)), dtype=bool)
            for cdata, cattrs in contacts[cid].values():
                y |= load_interface_labels(MemGroup(cdata, cattrs), t0, t1_l)
            items.append((np.asarray(data["X"], np.float32), np.asarray(data["ids_topk"]).astype(np.int64),
                          q, M, y.astype(np.float32)))
    return items


def phase_build(dev, tmp, card):
    """The dataset slice on the card at full width: the per-file build
    (contacts and per-subunit kNN) against the CPU's, the kNN kernel on
    every subunit's own unpadded shape, the build's rate and stage split
    with 0 and 4 host workers, and evaluate's and confidence's functions on
    the built items with i_v4_1. Returns its numbers."""
    import contextlib
    import io

    import numpy as np
    import torch

    from pesto_tpu_torch.apps.confidence import confidence_rows
    from pesto_tpu_torch.apps.evaluate import evaluate_items
    from pesto_tpu_torch.batching import pad_structure_arrays
    from pesto_tpu_torch.data import build
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.ops import knn
    from pesto_tpu_torch.ops.edge_attention import edge_attention_kernel
    from pesto_tpu_torch.port import init_state_dict

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    cfg_build = dict(build.DEFAULT_CONFIG)
    paths, atoms = [], {}
    for fname, n_chains, per_chain, hets, seed in BUILD_FILES:
        paths.append(os.path.join(tmp, fname))
        atoms[paths[-1]] = complex_pdb(paths[-1], n_chains, per_chain, hets, seed)
    broken = os.path.join(tmp, "4bad.pdb1")
    with open(broken, "w") as f:
        f.write("this is not a pdb file\n")
    paths.append(broken)
    part_done("inputs")

    # per file: the host part once, then contacts and kNN on the card and on
    # the CPU; the kNN launches counted around the card's part alone
    res = {"files": {}}
    built, knn_dev, knn_ties = [], 0.0, 0
    for path in paths:
        name = os.path.basename(path)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            prep = build._prepare_for_build(path, cfg_build)
        printed = out.getvalue().strip()
        if prep is None:
            readable = path != broken
            ok = (printed == "" if readable else printed.startswith(f"ReadError: {path}: "))
            log(f"build {name}: skipped ({'>= max_num_atoms' if readable else 'unreadable'}); "
                f"printed {printed!r}")
            if not ok or (readable and atoms[path] < cfg_build["max_num_atoms"]):
                raise AssertionError(f"build {name}: not skipped as the JAX package skips it")
            res["files"][name] = {"skipped": True, "printed": printed}
            continue
        subunits, encoded = prep[2], prep[3]
        torch.cuda.synchronize()
        knn.knn_kernel.launches = 0
        t0 = time.perf_counter()
        got = build._pack_for_build(prep, cfg_build, dev)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        launches = knn.knn_kernel.launches
        want = build._pack_for_build(prep, cfg_build, "cpu")
        # contacts one side has and the other lacks: only within CONTACT_EDGE of r_thr
        c_card = build.extract_all_contacts(subunits, cfg_build["r_thr"], device=dev)
        c_cpu = build.extract_all_contacts(subunits, cfg_build["r_thr"], device="cpu")
        odd = contact_pairs(c_card) ^ contact_pairs(c_cpu)
        for a, b, i, j in odd:
            d = float(np.linalg.norm(subunits[a]["xyz"][i].astype(np.float64) - subunits[b]["xyz"][j]))
            log(f"build {name}: contact {a}[{i}]-{b}[{j}] at {d!r} A on one side only")
            if abs(d - cfg_build["r_thr"]) > CONTACT_EDGE:
                raise AssertionError(f"build {name}: a contact {d} A from r_thr differs")
        if odd:  # then the CPU packs from the card's contacts
            want = prep[:2] + build.pack_dataset_items(
                subunits, c_card, cfg_build["molecule_ids"], cfg_build["max_num_nn"], device="cpu",
                encoded=encoded)
        tie_rows = same_items(name, got, want)
        n_sub = len(got[2])
        if launches != n_sub:
            raise AssertionError(f"build {name}: {launches} kNN launches for {n_sub} subunits with a contact")
        # the kernel against knn_plain on each subunit's own shape (NA = n + 1)
        shapes = []
        for cid in got[2]:
            X = encoded[cid][0]
            Xp, mp_ = padded_batch([X], len(X) + 1)
            case = check_knn_case(f"{name} {cid}", Xp, mp_, knn, dev, timed=False)
            knn_dev, knn_ties = max(knn_dev, case["dev"]), knn_ties + case["tie_rows"]
            shapes.append((cid, len(X), min(cfg_build["max_num_nn"], len(X)), case["tie_rows"]))
        n_pairs = len(contact_pairs(c_card))
        res["files"][name] = {"atoms": atoms[path], "subunits": len(subunits), "with_contact": n_sub,
                              "knn_launches": launches, "contact_pairs": n_pairs, "one_sided": len(odd),
                              "ids_topk_tie_rows": tie_rows, "card_ms": card_ms}
        log(f"build {name} [{card}]: {atoms[path]} atoms, {len(subunits)} subunits, {n_sub} with a contact, "
            f"{n_pairs} contact pairs ({len(odd)} on one side only), knn launches {launches} "
            f"(expect {n_sub}); card items equal the CPU's, {tie_rows} ids_topk rows differ by ties; "
            f"contacts + kNN + pack on the card {card_ms:.1f} ms; kNN kernel vs plain per subunit "
            f"(cid, n, k, tie rows): {shapes}")
        built.append(got)
    res["knn_dev"], res["knn_tie_rows"] = knn_dev, knn_ties
    part_done("per-file checks")

    # the build's rate and where its time goes, by the host clock with a
    # synchronise at each stage's edges (the wrappers are this script's)
    stage_fns = {"contacts": "extract_all_contacts", "knn": "extract_topology",
                 "pack_with_knn": "pack_dataset_items"}
    originals = {k: getattr(build, f) for k, f in stage_fns.items()}
    acc = {}

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[key] += 1e3 * (time.perf_counter() - t0)
            return out
        return wrapper

    timed_paths = paths * BUILD_COPIES
    res["rate"] = {}
    try:
        for key, fname in stage_fns.items():
            setattr(build, fname, timed(key, originals[key]))
        for workers in BUILD_WORKERS:
            acc.update({k: 0.0 for k in stage_fns})
            knn.knn_kernel.launches = 0
            t0 = time.perf_counter()
            items = []
            with contextlib.redirect_stdout(io.StringIO()):
                # no device given: the build's default is the card
                for it in build.build_items(timed_paths, cfg_build, num_workers=workers):
                    items.append(it)
                    if len(items) == 1:
                        first = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            packed = sum(len(d["X"]) for it in items if it is not None for d, _ in it[2].values())
            kept = [it for it in items if it is not None]
            for a, b in zip(kept, built * BUILD_COPIES):
                same_items(f"timed {workers} workers", a, b)
            split = {"host": wall - acc["contacts"] - acc["pack_with_knn"], "contacts": acc["contacts"],
                     "knn": acc["knn"], "pack": acc["pack_with_knn"] - acc["knn"]}
            r = {"files": len(timed_paths), "wall_ms": wall, "first_item_ms": first,
                 "files_per_s": len(timed_paths) / wall * 1e3,
                 "packed_atoms_per_s": packed / wall * 1e3, "knn_launches": knn.knn_kernel.launches,
                 "stage_ms": split}
            res["rate"][workers] = r
            want_launches = BUILD_COPIES * sum(f["with_contact"] for f in res["files"].values()
                                               if not f.get("skipped"))
            log(f"build rate [{card}], num_workers={workers}: {len(timed_paths)} files ({len(kept)} kept, "
                f"{packed} atoms packed) in {wall:.1f} ms, the first after {first:.1f} ms (with workers, "
                f"the pool's start): {r['files_per_s']:.2f} files/s, "
                f"{r['packed_atoms_per_s']:.0f} packed atoms/s; stage ms "
                f"{json.dumps({k: round(v, 2) for k, v in split.items()})}; knn launches {r['knn_launches']} "
                f"(expect {want_launches})")
            if r["knn_launches"] != want_launches:
                raise AssertionError(f"build with {workers} workers: {r['knn_launches']} kNN launches")
    finally:
        for key, fname in stage_fns.items():
            setattr(build, fname, originals[key])
    part_done("build rate")

    # the built items scored as evaluate and confidence score a dataset
    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    pred = Predictor(cfg, sd)  # no device given: the card
    items = dataset_items(built, cfg.feature_flags)
    labelled = sum(1 for it in items if it[4].sum() > 0)
    edge_attention_kernel.launches = 0
    t0 = time.perf_counter()
    rows = evaluate_items(items, pred)
    torch.cuda.synchronize()
    ev_ms = 1e3 * (time.perf_counter() - t0)
    ev_launches = edge_attention_kernel.launches
    edge_attention_kernel.launches = 0
    t0 = time.perf_counter()
    bins, summary = confidence_rows(items, pred)
    torch.cuda.synchronize()
    conf_ms = 1e3 * (time.perf_counter() - t0)
    conf_launches = edge_attention_kernel.launches
    log(f"evaluate [{card}] over {len(items)} built items ({labelled} labelled): {ev_ms:.1f} ms, edge launches "
        f"{ev_launches} (expect {n_layers * labelled}); rows {json.dumps(rows, default=float)}")
    log(f"confidence [{card}] over {len(items)} items: {conf_ms:.1f} ms, edge launches {conf_launches} (expect "
        f"{n_layers * len(items)}); {json.dumps(summary)}; bins with residues "
        f"{sum(1 for b in bins if b['count'])} of {len(bins)}")
    if ev_launches != n_layers * labelled or conf_launches != n_layers * len(items):
        raise AssertionError(f"edge launches {ev_launches}, {conf_launches}")
    # a metric may be NaN where a class has no positive prediction; the
    # accuracy is always defined
    if not rows or not all(r["n"] >= 1 and np.isfinite(r["acc"]) for r in rows) or sum(
            b["count"] for b in bins) != summary["residues"] or not np.isfinite(summary["accuracy"]):
        raise AssertionError("evaluate or confidence gave no rows")

    # one item through the card and through the CPU's plain versions
    small = min(items, key=lambda it: len(it[0]))
    ps = pad_structure_arrays(small[0], small[2], small[3], ids_topk_raw=small[1])
    p_card = pred.probabilities(ps)
    t0 = time.perf_counter()
    p_cpu = Predictor(cfg, sd, device="cpu").probabilities(ps)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(p_card - p_cpu).max())
    log(f"built item of {len(small[0])} atoms, card vs CPU probabilities: max abs diff {err:.3g} "
        f"(atol {PROB_ATOL}); CPU {cpu_s:.1f} s")
    if not err <= PROB_ATOL:
        raise AssertionError(f"built item: card and CPU probabilities differ by {err}")
    res["score"] = {"items": len(items), "labelled": labelled, "evaluate_ms": ev_ms, "confidence_ms": conf_ms,
                    "edge_launches": [ev_launches, conf_launches], "rows": rows, "confidence": summary,
                    "prob_err": err}
    part_done("scoring")
    log(f"phase 8 parts (s): {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    res["parts_s"] = parts
    return res


# ---------------------------------------------------------------- phase 9

MD_STRUCTURE = (8191, 1024, 1)  # atoms, residues, seed: phase 4's synthetic structure
MD_FRAMES, MD_CHUNK = 64, 8
MD_STEP = 0.1  # rms displacement of every atom per frame (A), a random walk
MD_RUNS = 3
MD_CPU = (4, 2)  # frames and chunk of the 1OL5 card-vs-CPU check
CLI_FRAMES = 16
CROSS_SMALL = (1000, 125)  # atoms and residues per structure of the card-vs-CPU cross check
CROSS_RUNS = 3
TOOLKIT_CPU_FRAMES = 8  # frames of the trajectory that the CPU recomputes
SASA_FRAMES = 4
SASA_CPU_ATOMS = 1000  # atoms of the 1OL5 crop of the SASA card-vs-CPU check
COORD_ATOL = 1e-4  # A: superposed coordinates, RMSD, iRMSD, card vs CPU


def random_walk(xyz, T, step, seed):
    """T frames from xyz (frame 0 exactly xyz): every atom takes a seeded
    Gaussian step of rms `step` A per frame."""
    import numpy as np

    rng = np.random.RandomState(seed)
    steps = (rng.randn(T, *xyz.shape) * (step / np.sqrt(3.0))).astype(np.float32)
    steps[0] = 0.0
    return (xyz[None] + np.cumsum(steps, axis=0)).astype(np.float32)


def profile_call(fn):
    """fn() once under torch.profiler: (wall ms, device busy ms, device ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    return wall, sum(kernels), len(kernels)


def phase_traj(dev, tmp):
    """Trajectories and the dimer model at full width (i_v4_1, 32 layers,
    seeded random weights): predict_trajectory, the md and complexes CLIs,
    evaluate_complex, the cross model forward and backward, and the traj/
    toolkit, each held against the CPU. Returns its numbers."""
    import copy
    import statistics
    import types

    import numpy as np
    import torch

    from pesto_tpu_torch import traj
    from pesto_tpu_torch.apps import complexes, md
    from pesto_tpu_torch.batching import encode_and_pad
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.io import read_pdb, read_structure, save_traj_pdb
    from pesto_tpu_torch.models import CrossPestoModel, get_config
    from pesto_tpu_torch.ops.edge_attention import edge_attention_backward_kernel
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.structure import (clean_structure, concatenate_chains, preprocess_structure,
                                           split_by_chain, tag_hetatm_chains)
    from pesto_tpu_torch.synthetic import random_structure_record
    from pesto_tpu_torch.traj import sasa, stats

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    pred = Predictor(cfg, sd, device=dev)
    # the checks against the CPU's plain versions run i_v4_0 (16 layers of
    # the same width, every nn): the CPU's 32-layer forward at 4096 atoms
    # takes ~8 s, and the phase stays under 90 s
    cfg16 = get_config("i_v4_0")
    sd16 = init_state_dict(cfg16, seed=0)
    pred16 = {d: Predictor(cfg16, sd16, device=d) for d in (dev, "cpu")}
    res = {}

    # predict_trajectory at full width: 64 frames of the 8191-atom structure
    n_atoms, n_res, seed = MD_STRUCTURE
    synth = random_structure_record(n_atoms=n_atoms, n_res=n_res, seed=seed)
    frames = random_walk(synth["xyz"], MD_FRAMES, MD_STEP, seed=90)
    md.predict_trajectory(pred, synth, frames[:MD_CHUNK], chunk=MD_CHUNK)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first_ms, probs = host_ms(lambda: md.predict_trajectory(pred, synth, frames, chunk=MD_CHUNK))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_chunks = -(-MD_FRAMES // MD_CHUNK)
    want = {"knn": 1, "edge": n_layers * n_chunks}
    log(f"md: {MD_FRAMES} frames x {n_atoms} atoms, chunk {MD_CHUNK}: launches knn {launches['knn']}, edge "
        f"{launches['edge']} (expect {want['knn']}, {want['edge']}: 1 kNN for the frozen topology, "
        f"{n_layers} edge per chunk); peak memory {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"md launches {launches}, expected {want}")
    if probs.shape != (MD_FRAMES, n_res, cfg.dm_n2) or not np.isfinite(probs).all():
        raise AssertionError(f"md probabilities {probs.shape}, finite {np.isfinite(probs).all()}")
    static = pred.predict_structure(synth)
    err0 = float(np.abs(probs[0] - static).max())
    moved = float(np.abs(probs[-1] - probs[0]).max())
    log(f"md frame 0 vs predict_structure on the card: max abs diff {err0:.3g} (atol {PROB_ATOL}); "
        f"frame {MD_FRAMES - 1} moved the probabilities by up to {moved:.3g}")
    if not err0 <= PROB_ATOL:
        raise AssertionError(f"md frame 0 differs from predict_structure by {err0}")
    times = [host_ms(lambda: md.predict_trajectory(pred, synth, frames, chunk=MD_CHUNK))[0]
             for _ in range(MD_RUNS)]
    med = statistics.median(times) / 1e3
    wall, busy, n_ops = profile_call(lambda: md.predict_trajectory(pred, synth, frames[:MD_CHUNK],
                                                                   chunk=MD_CHUNK))
    pred_bf16 = Predictor(cfg.replace(dtype="bfloat16"), sd, device=dev)
    p_bf16 = md.predict_trajectory(pred_bf16, synth, frames[:MD_CHUNK], chunk=MD_CHUNK)
    bf16_err = float(np.abs(p_bf16 - probs[:MD_CHUNK]).max())
    del pred_bf16
    res["md"] = {"frames": MD_FRAMES, "atoms": n_atoms, "chunk": MD_CHUNK, "launches": launches,
                 "first_call_ms": first_ms, "runs_ms": times, "frames_per_s": MD_FRAMES / med,
                 "atoms_per_s": MD_FRAMES * n_atoms / med, "peak_gib": peak, "frame0_err": err0,
                 "one_chunk_call": {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
                                    "device_ops": n_ops},
                 "bf16_err": bf16_err}
    log(f"md rate: {MD_FRAMES / med:.2f} frames/s, {MD_FRAMES * n_atoms / med:.0f} atoms/s (median of "
        f"{MD_RUNS}: {', '.join(f'{t:.1f}' for t in times)} ms per {MD_FRAMES} frames; first {first_ms:.1f}); "
        f"one call of one chunk (topology and {MD_CHUNK} frames) profiled: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms (share {busy / wall:.3f}), {n_ops} device operations; bf16 chunk vs fp32 max abs "
        f"diff {bf16_err:.3g} (atol {BF16_PROB_ATOL})")
    if not bf16_err <= BF16_PROB_ATOL:
        raise AssertionError(f"md bf16 and fp32 probabilities differ by {bf16_err}")
    part_done("md")

    # the edge kernel on one chunk's own inputs: B frames that share one ids block
    inputs = capture_edge_inputs(lambda: md.predict_trajectory(pred, synth, frames[:MD_CHUNK], chunk=MD_CHUNK))
    na = next(iter(inputs.values()))[1].shape[0] // MD_CHUNK  # the structure's bucket
    for nn, args in inputs.items():
        local = args[1].long().reshape(MD_CHUNK, na, nn)
        local = local - na * torch.arange(MD_CHUNK, device=local.device)[:, None, None]
        if not torch.equal(local, local[:1].expand_as(local)):
            raise AssertionError(f"md chunk nn={nn}: the frames do not share one ids block")
    res["edge_errs"] = check_edge_inputs(inputs, "md chunk (float32)", FP32_TOL, MD_CHUNK, na)
    part_done("edge kernel")

    # the md and complexes CLIs on the card, in subprocesses, while the
    # CPU checks below run: chain A of phase 8's complex over 16 frames
    cpx = os.path.join(tmp, BUILD_FILES[0][0])
    complex_pdb(cpx, *BUILD_FILES[0][1:])
    raw = read_pdb(cpx)
    keep = (raw["chain_name"] == "A:0") & (raw["het_flag"] == "A")
    chain_a = {k: v[keep] for k, v in raw.items() if k not in ("chain_name", "icode", "bfactor")}
    chain_a["xyz"] = random_walk(chain_a["xyz"], CLI_FRAMES, MD_STEP, seed=92)
    traj_path, ckpt = os.path.join(tmp, "trajA.pdb"), os.path.join(tmp, "i_v4_1.pt")
    save_traj_pdb({"A": chain_a}, traj_path)
    torch.save(sd, ckpt)
    md_csv = os.path.join(tmp, "md.csv")
    argvs = {"md": ["pesto_tpu_torch.apps.md", traj_path, "--ref", cpx, "--ckpt", ckpt, "--every", "1",
                    "--out", md_csv],
             "complexes": ["pesto_tpu_torch.apps.complexes", cpx, "--ckpt", ckpt]}
    t_cli = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", *a], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, a in argvs.items()}
    try:
        # card vs CPU: predict_trajectory on 1OL5
        golden = concatenate_chains(preprocess_structure(read_structure(GOLDEN)))
        T, chunk = MD_CPU
        gframes = random_walk(golden["xyz"], T, MD_STEP, seed=91)
        p_card, p_cpu = (md.predict_trajectory(pred16[d], golden, gframes, chunk=chunk) for d in (dev, "cpu"))
        md_cpu_err = float(np.abs(p_card - p_cpu).max())
        res["md_cpu_err"] = md_cpu_err
        log(f"md 1OL5, {T} frames, chunk {chunk}, i_v4_0: card vs CPU max abs diff {md_cpu_err:.3g} "
            f"(atol {PROB_ATOL})")
        if not md_cpu_err <= PROB_ATOL:
            raise AssertionError(f"md 1OL5 card vs CPU differ by {md_cpu_err}")
        part_done("md card vs CPU")

        # card vs CPU: evaluate_complex on the complex
        structure = read_structure(cpx)
        ec = {k: complexes.evaluate_complex(pred16[d], structure) for k, d in (("card", dev), ("cpu", "cpu"))}
        if sorted(ec["card"]) != sorted(ec["cpu"]) or len(ec["card"]) != 2:
            raise AssertionError(f"evaluate_complex chains {sorted(ec['card'])} vs {sorted(ec['cpu'])}")
        ec_err = 0.0
        for cid, (p, y, afs) in ec["card"].items():
            cp, cy, cafs = ec["cpu"][cid]
            if not (np.array_equal(y, cy) and np.array_equal(afs, cafs)) or not 0 < y.sum() < len(y):
                raise AssertionError(f"evaluate_complex {cid}: labels or confidences differ, or one class")
            ec_err = max(ec_err, float(np.abs(p - cp).max()))
        res["complex_cpu_err"] = ec_err
        log(f"evaluate_complex on the {BUILD_FILES[0][1]} x {BUILD_FILES[0][2]}-atom complex, i_v4_0: card vs CPU "
            f"max abs diff {ec_err:.3g} (atol {PROB_ATOL}); interface residues "
            f"{ {c: int(v[1].sum()) for c, v in ec['card'].items()} }")
        if not ec_err <= PROB_ATOL:
            raise AssertionError(f"evaluate_complex card vs CPU differ by {ec_err}")
        part_done("evaluate_complex")

        # the cross model at full width on the complex's two chains
        subunits = split_by_chain(tag_hetatm_chains(clean_structure(structure)))

        def cross_inputs(s, device):
            ps = encode_and_pad(s, feature_flags=cfg.feature_flags, device=device)
            return tuple(torch.as_tensor(x).to(device) for x in (ps.X, ps.ids_topk, ps.q, ps.M, ps.atom_mask))

        torch.manual_seed(0)
        cross_cpu = CrossPestoModel(cfg)
        cross = copy.deepcopy(cross_cpu).to(dev)
        A, B = cross_inputs(subunits["A:0"], dev), cross_inputs(subunits["B:0"], dev)

        def fwd_bwd(model, A, B, timed):
            """sum(zA^2) + sum(zB^2) and its gradient: (forward ms, backward
            ms by CUDA events where timed, zA, zB)."""
            model.zero_grad(set_to_none=True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if timed else [None] * 3
            if timed:
                ev[0].record()
            zA, zB = model(A, B)
            loss = (zA**2).sum() + (zB**2).sum()
            if timed:
                ev[1].record()
            loss.backward()
            if not timed:
                return None, None, zA, zB
            ev[2].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), zA, zB

        fwd_bwd(cross, A, B, True)  # warm
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        edge_attention_backward_kernel.launches = 0
        runs = [fwd_bwd(cross, A, B, True) for _ in range(CROSS_RUNS)]
        cross_launches = read_launches()
        cross_bwd = edge_attention_backward_kernel.launches
        cross_peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"knn": 0, "edge": 2 * n_layers * CROSS_RUNS}
        if cross_launches != want or cross_bwd != 2 * n_layers * CROSS_RUNS:
            raise AssertionError(f"cross launches {cross_launches}, backward {cross_bwd}, expected {want} and "
                                 f"{2 * n_layers * CROSS_RUNS} backward (2 per layer per forward and backward)")
        for k, prm in cross.named_parameters():
            if prm.grad is None or not torch.isfinite(prm.grad).all():
                raise AssertionError(f"cross {k}.grad is {'None' if prm.grad is None else 'not finite'}")
        zA, zB = runs[-1][2:]
        if not (torch.isfinite(zA).all() and torch.isfinite(zB).all()):
            raise AssertionError("cross logits not finite")
        fwd_ms = statistics.median(r[0] for r in runs)
        bwd_ms = statistics.median(r[1] for r in runs)
        log(f"cross i_v4_1 on chains A, B ({int(A[4].sum())} + {int(B[4].sum())} atoms, buckets "
            f"{A[0].shape[0]}, {B[0].shape[0]}): edge launches {cross_launches['edge']} in {CROSS_RUNS} "
            f"forwards ({2 * n_layers} each), edge backward launches {cross_bwd} in {CROSS_RUNS} backwards "
            f"({2 * n_layers} each); forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (median "
            f"of {CROSS_RUNS}, CUDA events); peak memory {cross_peak:.2f} GiB; every gradient finite")
        part_done("cross card")

        # card vs CPU on a 2 x 1000-atom pair, the same ids on both
        small = [random_structure_record(n_atoms=CROSS_SMALL[0], n_res=CROSS_SMALL[1], seed=s) for s in (93, 94)]
        A, B = (cross_inputs(s, dev) for s in small)
        _, _, zA, zB = fwd_bwd(cross, A, B, False)
        _, _, cA, cB = fwd_bwd(cross_cpu, *[tuple(t.cpu() for t in S) for S in (A, B)], False)
        logit_err = max(float((zA.detach().cpu() - cA.detach()).abs().max()),
                        float((zB.detach().cpu() - cB.detach()).abs().max()))
        gerr = grad_errors(types.SimpleNamespace(model=cross), types.SimpleNamespace(model=cross_cpu))
        worst = max(gerr, key=gerr.get)
        log(f"cross on {CROSS_SMALL[0]}-atom pair, card vs CPU: logits max abs diff {logit_err:.3g} (atol "
            f"{PROB_ATOL}); worst gradient {worst} rel L2 {gerr[worst]:.3g} (tol {TRAIN_GRAD_RTOL})")
        if not logit_err <= PROB_ATOL or not gerr[worst] <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"cross card vs CPU: logits {logit_err}, gradient {worst} {gerr[worst]}")
        res["cross"] = {"launches_per_forward": 2 * n_layers, "bwd_launches": cross_bwd, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
                        "runs_ms": [r[:2] for r in runs], "peak_gib": cross_peak, "logit_err": logit_err,
                        "grad_rel_l2": gerr[worst], "atoms": [int(A[4].sum()), int(B[4].sum())]}
        del cross, cross_cpu
        part_done("cross card vs CPU")

        # the traj/ toolkit on the 64-frame trajectory, two halves as subunits
        h = n_atoms // 2
        ref_R, ref_L, rR, rL = synth["xyz"][:h], synth["xyz"][h:], synth["resid"][:h], synth["resid"][h:]
        bins = np.linspace(0.0, 10.0, 21)

        def toolkit(fr, device):
            fR, fL = fr[:, :h], fr[:, h:]
            return {
                "superpose": lambda: traj.superpose(synth["xyz"], fr, device=device),
                "rmsd": lambda: traj.rmsd(synth["xyz"], fr, device=device),
                "contacts_per_frame": lambda: traj.contacts_per_frame(fR, fL, device=device),
                "fnat": lambda: traj.fnat(ref_R, ref_L, rR, rL, fR, fL, device=device),
                "irmsd": lambda: traj.irmsd(ref_R, ref_L, rR, rL, fR, fL, device=device),
                "contacts_distribution": lambda: stats.contacts_distribution(fR, fL, bins, device=device),
            }

        tk_ms, card_out = {}, {}
        for name, fn in toolkit(frames, dev).items():
            fn()  # warm
            tk_ms[name], card_out[name] = host_ms(fn)
        cpu_frames = frames[:TOOLKIT_CPU_FRAMES]
        card8 = {name: fn() for name, fn in toolkit(cpu_frames, dev).items()}
        tk_err = {}
        for name, fn in toolkit(cpu_frames, "cpu").items():
            got, want = card8[name], fn()
            if name in ("superpose", "rmsd", "irmsd"):
                tk_err[name] = float(np.abs(got - want).max())
                ok = tk_err[name] <= COORD_ATOL
            else:
                got, want = (got, want) if name != "contacts_per_frame" else (np.concatenate(
                    [got[0][:, None], got[1]], 1), np.concatenate([want[0][:, None], want[1]], 1))
                tk_err[name] = float(np.abs(np.asarray(got, np.float64) - want).sum())
                ok = tk_err[name] == 0
            if not ok:
                raise AssertionError(f"traj {name}: card vs CPU differ by {tk_err[name]}")
        log(f"traj toolkit on {MD_FRAMES} frames ({h} + {n_atoms - h} atoms), card ms: "
            f"{json.dumps({k: round(v, 2) for k, v in tk_ms.items()})}; card vs CPU on {TOOLKIT_CPU_FRAMES} "
            f"frames: {json.dumps(tk_err)} (coordinates atol {COORD_ATOL} A, counts equal); fnat "
            f"{card_out['fnat'].min():.3f}-{card_out['fnat'].max():.3f}, rmsd up to "
            f"{card_out['rmsd'].max():.3f} A, {int(card_out['contacts_distribution'].sum())} distances "
            f"binned")
        sasa_ms, sasa_out = host_ms(lambda: sasa.shrake_rupley(synth, frames=frames[:SASA_FRAMES], device=dev))
        crop = {k: v[:SASA_CPU_ATOMS] for k, v in clean_structure(read_structure(GOLDEN)).items()}
        s_card = sasa.shrake_rupley(crop, device=dev)
        s_cpu = sasa.shrake_rupley(crop, device="cpu")
        radii = np.array([sasa.VDW_RADII.get(str(e), 1.8) for e in crop["element"]]) + sasa.PROBE_RADIUS
        s_err = float(np.abs(s_card - s_cpu).max())
        total_rel = float(abs(s_card.sum() - s_cpu.sum()) / s_cpu.sum())
        log(f"shrake_rupley: {SASA_FRAMES} frames of {n_atoms} atoms in {sasa_ms:.1f} ms "
            f"({sasa_ms / SASA_FRAMES:.1f} ms per frame), total {sasa_out.sum(1).mean():.0f} A^2 per frame; "
            f"{SASA_CPU_ATOMS}-atom 1OL5 crop card vs CPU: max per-atom diff {s_err:.3g} A^2, total rel "
            f"{total_rel:.3g}")
        if not (np.all(np.abs(s_card - s_cpu) <= 4 * np.pi * radii**2 / 128 + 1e-3) and total_rel <= 1e-3
                and np.isfinite(sasa_out).all()):
            raise AssertionError(f"shrake_rupley card vs CPU: per atom {s_err}, total {total_rel}")
        res["toolkit"] = {"card_ms": tk_ms, "cpu_err": tk_err, "sasa_ms_per_frame": sasa_ms / SASA_FRAMES,
                          "sasa_err": s_err, "sasa_total_rel": total_rel}
        part_done("toolkit")

        # the CLIs' results
        outs = {}
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            outs[k] = (proc.returncode, out, err)
        cli_s = time.perf_counter() - t_cli
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, (rc, out, err) in outs.items():
        for line in out.strip().splitlines()[-3:]:
            log(f"  {k} | {line}")
        if rc != 0:
            raise AssertionError(f"{k} CLI exited {rc}:\n{err[-4000:]}")
    with open(md_csv) as f:
        rows = f.read().strip().splitlines()[1:]
    if len(rows) != CLI_FRAMES or not all(np.isfinite(float(r.split(",")[1])) for r in rows):
        raise AssertionError(f"md CLI wrote {len(rows)} rows (expect {CLI_FRAMES} with finite AUCs)")
    summary = json.loads(outs["complexes"][1].strip().splitlines()[-1])
    if summary["n_chains"] != 2:
        raise AssertionError(f"complexes CLI summary {summary}")
    log(f"CLIs on the card in {cli_s:.1f} s (beside the CPU checks): md wrote {len(rows)} rows, "
        f"complexes summary {json.dumps(summary)}")
    res["clis"] = {"md_rows": len(rows), "complexes": summary, "seconds": cli_s}
    part_done("clis")
    log(f"phase 9 parts (s): {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    res["parts_s"] = parts
    return res


# ---------------------------------------------------------------- phase 10

SHARD_TABLE = 32768           # rows of the edge kernel's table in the shard check
SHARD_ROWS = (16384, 8192)    # shard sizes, at every offset of the table
DP_STEPS = 3                  # train steps of each DP run (phase 6's first epoch)
DP_LR = 1e-4
DP_LOSS_RTOL = 1e-5           # JAX's own, DP against one device (tests/test_sharding.py:47-52)
DP_PARAM_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 compute on fp32 masters: each rank rounds its own bf16 weight
# gradients before the fp32 sum, and Adam turns a flipped sign of a small
# gradient into 2 lr per step
DP_BF16_LOSS_RTOL = 1e-3
DP_BF16_PARAM_ATOL = 2 * DP_STEPS * DP_LR + DP_PARAM_TOL["atol"]
DP_BF16_SHARE = 0.05          # of the weights beyond the fp32 tolerance
# biases whose gradient is 0 in exact arithmetic (each adds one value to
# every logit of a softmax): held to a rounding-zero gradient instead
ZERO_GRAD = r"spl\.sam\.4\.bias|sum\.\d+\.su\.eqkm\.4\.bias"
ZERO_GRAD_REL = 1e-5          # of the largest gradient entry
DP_SERVE_TOL = 1e-5           # JAX's own for mesh serving (tests/test_serving_mesh.py:37-54)
SP_PROB_ATOL = 1e-4
SP_LOGIT_ATOL = 1e-4          # the batched 2-D forward against one device
# atoms, residues, seed, shard counts, held against predict_structure
SP_STRUCTURES = ((32767, 4096, 31, (2, 4), True), (65535, 8192, 32, (2,), False))


def edge_shard_cases(dev):
    """The edge kernel on shards of one table (SHARD_TABLE rows, ids over
    the whole table, nn=64), every shard of SHARD_ROWS rows at every
    offset, fp32 and bf16, against its plain version and held bit for bit
    to the whole table's launch (the same kernel at row0 = 0); and the time
    of an 8192-row shard at offset 8192. Returns ({dtype: max abs err},
    ms)."""
    import torch

    from pesto_tpu_torch.ops import edge_attention as ea

    worst, shard_ms = {}, None
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        full = edge_inputs(SHARD_TABLE, 64, dt, dev, seed=77)
        whole = ea.edge_attention_kernel(*full)
        name = str(dt)[6:]
        worst[name] = 0.0
        for rows in SHARD_ROWS:
            for row0 in range(0, SHARD_TABLE, rows):
                args = [full[0], *(t[row0 : row0 + rows] for t in full[1:5]), *full[5:]]
                got = ea.edge_attention_kernel(*args, row0=row0)
                torch.cuda.synchronize()
                want = ea.edge_attention_plain(*args, row0=row0)
                err = 0.0
                for a, b in zip(got, want):
                    a, b = a.float(), b.float()
                    excess = ((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs()).max().item()
                    if excess > 0 or not torch.isfinite(a).all():
                        raise AssertionError(f"edge shard {rows}@{row0} {dt}: beyond tolerance by {excess}")
                    err = max(err, (a - b).abs().max().item())
                if not all(torch.equal(a, w[row0 : row0 + rows]) for a, w in zip(got, whole)):
                    raise AssertionError(f"edge shard {rows}@{row0} {dt}: rows differ from the whole table's "
                                         f"launch")
                worst[name] = max(worst[name], err)
                line = (f"edge shard of {rows} rows at row0={row0} of a {SHARD_TABLE}-row table, nn=64, "
                        f"{str(dt)[6:]}: max abs err {err:.3g}; rows equal bit for bit to the whole table's "
                        f"launch")
                if rows == 8192 and row0 == 8192 and dt == torch.float32:
                    shard_ms = cuda_time_ms(lambda: ea.edge_attention_kernel(*args, row0=row0))
                    line += f"; kernel {shard_ms:.4f} ms"
                log(line)
                del got, want
        del full, whole
        torch.cuda.empty_cache()
    return worst, shard_ms


def dp_train_rank(rank, dev, job):
    """One rank of a data-parallel run (spawned; see phase_parallel): the
    trainer's loader with process_count = world size, replicate_state, and
    DP_STEPS checked train steps per dtype, each timed by CUDA events.
    Returns per dtype the losses, step ms, kNN and edge launches, collectives, peak
    memory, the parameters after the last step and the gradients' largest
    entries."""
    import re

    import torch
    import torch.distributed as dist

    from pesto_tpu_torch.data.loader import BucketedLoader
    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.ops.edge_attention import edge_attention_backward_kernel, edge_attention_kernel
    from pesto_tpu_torch.ops.knn import knn_kernel
    from pesto_tpu_torch.parallel import comm, make_dp_train_step, replicate_state, shard_batch
    from pesto_tpu_torch.train import create_train_state

    _build.build_all(("knn", "edge_attention", "edge_attention_bwd"))  # built by the parent: loaded
    world = dist.get_world_size()
    ds = MemoryDataset(job["items"])
    loader = BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH, compact=True, seed=0,
                            batch_multiple=world, process_count=world, process_index=rank)
    batches = [shard_batch(b, dev) for b in list(loader)[:DP_STEPS]]
    out = {"backend": dist.get_backend(), "device": str(dev), "rows": [int(b.X.shape[0]) for b in batches]}
    for dtype in ("float32", "bfloat16"):
        state = create_train_state(job["cfg"].replace(dtype=dtype), DP_LR, state_dict=job["sd"], device=dev)
        replicate_state(state)
        step = make_dp_train_step()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        knn_kernel.launches = 0
        edge_attention_kernel.launches = 0
        edge_attention_backward_kernel.launches = 0
        comm.reset()
        losses, ms = [], []
        for batch in batches:
            state, t, loss = timed_step(state, step, batch)
            losses.append(loss)
            ms.append(t["step"])
        grads = {k: float(p.grad.abs().max()) for k, p in state.model.named_parameters()}
        out[dtype] = dict(
            losses=losses, step_ms=ms, collectives=comm.counts(),
            launches={"knn": knn_kernel.launches, "edge": edge_attention_kernel.launches},
            bwd_launches=edge_attention_backward_kernel.launches,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
            params={k: p.detach().cpu() for k, p in state.model.named_parameters()},
            zero_grad=max(v for k, v in grads.items() if re.fullmatch(ZERO_GRAD, k)),
            max_grad=max(grads.values()))
        del state
        torch.cuda.empty_cache()
    return out


def against_reference(label, dtype, got, want):
    """The losses and every parameter of a multi-device run (`got`: its
    "losses", "params", "zero_grad", "max_grad") after DP_STEPS steps
    against the one-device run `want`: (largest relative loss deviation,
    largest parameter deviation, share of the parameters beyond
    DP_PARAM_TOL, within tolerance). fp32: loss DP_LOSS_RTOL, every
    parameter within DP_PARAM_TOL, the ZERO_GRAD biases within Adam's
    bound; bf16: DP_BF16_*."""
    import re

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    worst, beyond, n = 0.0, 0, 0
    for k, p in got["params"].items():
        ref_p = want["params"][k]
        dev_abs = (p - ref_p).abs()
        if dtype == "float32" and re.fullmatch(ZERO_GRAD, k):
            # a rounding-zero gradient: Adam moves it by up to lr a step
            if not (dev_abs.max() <= 2 * DP_STEPS * DP_LR and got["zero_grad"] <= ZERO_GRAD_REL * got["max_grad"]):
                raise AssertionError(f"{label}: {k} moved {float(dev_abs.max())} with gradient "
                                     f"{got['zero_grad']}")
            continue
        over = dev_abs > DP_PARAM_TOL["atol"] + DP_PARAM_TOL["rtol"] * ref_p.abs()
        beyond += int(over.sum())
        n += p.numel()
        worst = max(worst, float(dev_abs.max()))
    share = beyond / n
    ok = (loss_rel <= DP_LOSS_RTOL and beyond == 0) if dtype == "float32" else (
        loss_rel <= DP_BF16_LOSS_RTOL and worst <= DP_BF16_PARAM_ATOL and share <= DP_BF16_SHARE)
    return loss_rel, worst, share, ok


def check_dp_run(name, ranks, ref, n_layers):
    """A DP run's ranks against the single-process run `ref`: the losses
    and every parameter after DP_STEPS steps, the ranks' replicas equal,
    no kNN launch (the items carry ids_topk), DP_STEPS * 32 edge launches
    and 3 collectives per step per rank.
    Returns its numbers."""
    import torch

    res = {"ranks": len(ranks), "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks]}
    for dtype in ("float32", "bfloat16"):
        r0, want = ranks[0][dtype], ref[dtype]
        for r in ranks:
            d = r[dtype]
            if d["losses"] != r0["losses"] or not all(torch.equal(v, r0["params"][k]) for k, v in d["params"].items()):
                raise AssertionError(f"DP {name} {dtype}: the ranks' losses or replicas differ")
            if d["launches"] != {"knn": 0, "edge": DP_STEPS * n_layers} or d["collectives"] != dict(d["collectives"], all_reduce=3 * DP_STEPS) \
                    or sum(d["collectives"].values()) != 3 * DP_STEPS or d["bwd_launches"] != DP_STEPS * n_layers:
                raise AssertionError(f"DP {name} {dtype}: launches {d['launches']}, backward {d['bwd_launches']}, "
                                     f"collectives {d['collectives']}")
        loss_rel, worst, share, ok = against_reference(f"DP {name}", dtype, r0, want)
        step_ms = [sorted(r[dtype]["step_ms"]) for r in ranks]
        res[dtype] = dict(loss_rel=loss_rel, max_param_dev=worst, share_beyond_fp32_tol=share,
                          step_ms=[r[dtype]["step_ms"] for r in ranks],
                          peak_gib=[r[dtype]["peak_gib"] for r in ranks],
                          launches={key: [r[dtype]["launches"][key] for r in ranks] for key in ("knn", "edge")},
                          bwd_launches=[r[dtype]["bwd_launches"] for r in ranks], collectives=r0["collectives"])
        log(f"DP train {name} {dtype}: {DP_STEPS} steps, losses {', '.join(f'{v:.7f}' for v in r0['losses'])} "
            f"(single process {', '.join(f'{v:.7f}' for v in want['losses'])}; max rel {loss_rel:.3g}); "
            f"params max abs dev {worst:.3g}, share beyond atol {DP_PARAM_TOL['atol']} / rtol "
            f"{DP_PARAM_TOL['rtol']} {share:.3g}; per rank: step ms {step_ms}, launches "
            f"{res[dtype]['launches']}, edge backward launches {res[dtype]['bwd_launches']} (expect "
            f"{DP_STEPS * n_layers}: {n_layers} per step), collectives {r0['collectives']}, peak "
            f"{', '.join(f'{g:.2f}' for g in res[dtype]['peak_gib'])} GiB (not a scaling figure: "
            f"{'one card' if len(set(res['devices'])) == 1 else 'two cards'})")
        if not ok:
            raise AssertionError(f"DP train {name} {dtype}: beyond tolerance")
    return res


def sp_train_run(name, mesh, cfg, sd, host, ref, dev):
    """DP x SP training on `mesh` (structures over its rows, atoms over its
    columns): DP_STEPS checked steps per dtype on the host batches `host`,
    timed by CUDA events, with per step the edge launches (one per cell
    per layer), the offsets they ran at, the kNN launches (none) and the
    collectives; the replicas equal to the master after each step; the
    losses and parameters held against the one-device run `ref`
    (`against_reference`), and one more fp32 step on the B=2 x 8192 batch
    under torch.profiler (`profile_step`). Then the batched 2-D forward on
    the mesh on that batch against the one-device logits at SP_LOGIT_ATOL,
    its ms beside one device's, and one of each under torch.profiler
    (`profile_call`). Returns its numbers."""
    import re

    import torch

    from pesto_tpu_torch.batching import to_device
    from pesto_tpu_torch.models import PestoModel
    from pesto_tpu_torch.models import pesto as pesto_model
    from pesto_tpu_torch.ops.edge_attention import edge_attention_backward_kernel
    from pesto_tpu_torch.parallel import comm, make_sp_forward, make_sp_train_step, shard_batch_sp
    from pesto_tpu_torch.train import create_train_state

    n_layers = len(cfg.layers)
    n_data, n_model = mesh.devices.shape
    row0s = []
    fused = pesto_model.fused_edge_attention

    def recording(*args, **kw):  # the offset of each edge launch of the layer stack
        row0s.append(kw.get("row0", 0))
        return fused(*args, **kw)

    want_calls = dict(merge_to=2, all_sum=n_data, all_max=n_data, all_gather_rows=n_data * n_layers,
                      sum_grads_to=1, copy_params=1)
    res = {"mesh": [[str(d) for d in row] for row in mesh.devices]}
    pesto_model.fused_edge_attention = recording
    try:
        for dtype in ("float32", "bfloat16"):
            state = create_train_state(cfg.replace(dtype=dtype), DP_LR, state_dict=sd, device=dev)
            step = make_sp_train_step(mesh)
            batches = [shard_batch_sp(b, mesh) for b in host]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for host_batch, batch in zip(host, batches):
                reset_launches()
                edge_attention_backward_kernel.launches = 0
                comm.reset()
                row0s.clear()
                state, t, loss = timed_step(state, step, batch)
                B, NA = host_batch.X.shape[:2]
                offsets = sorted(set(row0s))
                want_offsets = [B // n_data * a for a, _ in batch.bounds]
                runs.append(dict(loss=loss, ms=t, launches=read_launches(), calls=comm.counts(),
                                 bwd_launches=edge_attention_backward_kernel.launches,
                                 offsets=offsets, shape=[int(B), int(NA)]))
                replicas = list(dict.fromkeys(step.forward(state).replicas.values()))
                stale = [k for r in replicas[1:] for (k, w), v in zip(r.named_parameters(), state.model.parameters())
                         if not torch.equal(w, v)]
                if (runs[-1]["launches"] != {"knn": 0, "edge": n_layers * n_data * n_model}
                        or runs[-1]["bwd_launches"] != n_layers * n_data * n_model
                        or offsets != want_offsets or len(row0s) != n_layers * n_data * n_model
                        or runs[-1]["calls"] != dict(runs[-1]["calls"], **want_calls)
                        or sum(runs[-1]["calls"].values()) != sum(want_calls.values()) or stale):
                    raise AssertionError(f"SP train {name} {dtype} B={B}x{NA}: launches {runs[-1]['launches']}, "
                                         f"backward {runs[-1]['bwd_launches']}, "
                                         f"offsets {offsets} (expect {want_offsets}), collectives "
                                         f"{runs[-1]['calls']}, stale replica weights {stale[:3]}")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            grads = {k: float(p.grad.abs().max()) for k, p in state.model.named_parameters()}
            got = dict(losses=[r["loss"] for r in runs],
                       params={k: p.detach().cpu() for k, p in state.model.named_parameters()},
                       zero_grad=max(v for k, v in grads.items() if re.fullmatch(ZERO_GRAD, k)),
                       max_grad=max(grads.values()))
            loss_rel, worst, share, ok = against_reference(f"SP train {name}", dtype, got, ref[dtype])

            def ms_of(part):
                return ", ".join(f"{r['ms'][part]:.2f}" for r in runs)

            res[dtype] = dict(loss_rel=loss_rel, max_param_dev=worst, share_beyond_fp32_tol=share,
                              step_ms=[r["ms"]["step"] for r in runs], shapes=[r["shape"] for r in runs],
                              peak_gib=peak, replicas=len(replicas),
                              launches_per_step=[r["launches"] for r in runs],
                              bwd_launches_per_step=[r["bwd_launches"] for r in runs],
                              offsets=[r["offsets"] for r in runs], collectives_per_step=runs[0]["calls"])
            log(f"SP train {name} {dtype}: {DP_STEPS} steps on {[r['shape'] for r in runs]}, losses "
                f"{', '.join(f'{v:.7f}' for v in got['losses'])} (one device "
                f"{', '.join(f'{v:.7f}' for v in ref[dtype]['losses'])}; max rel {loss_rel:.3g}); params max abs "
                f"dev {worst:.3g}, share beyond atol {DP_PARAM_TOL['atol']} / rtol {DP_PARAM_TOL['rtol']} "
                f"{share:.3g}; step ms {ms_of('step')} (forward {ms_of('forward')}, backward "
                f"{ms_of('backward')}; CUDA events, the first a warm-up), "
                f"peak {peak:.2f} GiB, {len(replicas)} distinct replica(s); per step edge launches "
                f"{[r['launches']['edge'] for r in runs]} (expect {n_layers} layers x {n_data * n_model} "
                f"cells), edge backward launches {[r['bwd_launches'] for r in runs]} (expect the same), "
                f"kNN {[r['launches']['knn'] for r in runs]}, offsets {[r['offsets'] for r in runs]}, "
                f"collectives {runs[0]['calls']} (not a scaling figure: "
                f"{'one card' if len(set(res['mesh'][0] + res['mesh'][-1])) == 1 else 'two cards'})")
            if not ok:
                raise AssertionError(f"SP train {name} {dtype}: beyond tolerance")
            if dtype == "float32":
                # one more step, its forward and backward under torch.profiler
                # (phase 6 profiles one device's on the same batch)
                big = max(range(len(host)), key=lambda i: host[i].X.shape[1])
                prof = profile_step(state, step, batches[big])
                res["profile"] = prof
                shape = "x".join(map(str, host[big].X.shape[:2]))
                log(f"SP train {name}: profiled step fp32 B={shape}: forward device "
                    f"{prof['forward_device_ms']:.2f} ms over {prof['forward_kernels']} kernels, backward device "
                    f"{prof['backward_device_ms']:.2f} ms over {prof['backward_kernels']} kernels, of which the "
                    f"edge backward kernel {prof['edge_backward_ms']:.2f} ms in {prof['edge_backward_ranges']} "
                    f"ranges; the backward's top kernels (ms): {json.dumps(prof['backward_top'])}")
            del state, step, batches
            torch.cuda.empty_cache()

        # the batched 2-D forward against the one-device logits
        host_batch = max(host, key=lambda b: b.X.shape[1])  # B=2 x 8192
        b = to_device(host_batch, dev)
        nr = b.res_mask.shape[-1]
        model = PestoModel(cfg)
        model.load_state_dict(sd)
        model = model.to(dev).eval()
        args = (b.X, b.ids_topk, b.q, b.M, b.atom_mask)
        with torch.no_grad():
            want = model(*args, nr=nr)
            fwd = make_sp_forward(model, mesh, batch_axis=True)
            fwd(*args, nr=nr)  # warm
            torch.cuda.synchronize()
            reset_launches()
            comm.reset()
            row0s.clear()
            got = fwd(*args, nr=nr)
            torch.cuda.synchronize()
            launches, calls, offsets = read_launches(), comm.counts(), sorted(set(row0s))
            fwd_ms = cuda_time_ms(lambda: fwd(*args, nr=nr), reps=3, warmup=0)
            one_ms = cuda_time_ms(lambda: model(*args, nr=nr), reps=3, warmup=1)
            # (wall ms, device busy ms, device ops) of one forward each
            profiled = {"one device": profile_call(lambda: model(*args, nr=nr)),
                        name: profile_call(lambda: fwd(*args, nr=nr))}
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all()) and got.shape == want.shape
        shape = "x".join(map(str, host_batch.X.shape[:2]))
        log(f"SP forward {name}, batch_axis=True, B={shape}: max abs diff to one device {err:.3g} (atol "
            f"{SP_LOGIT_ATOL}), {fwd_ms:.2f} ms against {one_ms:.2f} ms on one device (CUDA events, mean of 3), "
            f"launches {launches}, offsets {offsets}, collectives {calls}; under torch.profiler "
            + "; ".join(f"{k}: wall {w:.2f} ms, device busy {b:.2f} ms, {n} device ops"
                        for k, (w, b, n) in profiled.items()))
        if not (finite and err <= SP_LOGIT_ATOL and launches == {"knn": 0, "edge": n_layers * n_data * n_model}):
            raise AssertionError(f"SP forward {name}: err {err}, launches {launches}, finite {finite}")
        res["forward"] = dict(err=err, ms=fwd_ms, one_device_ms=one_ms, launches=launches, collectives=calls,
                              profiled=profiled)
        del model, fwd, want, got
        torch.cuda.empty_cache()
    finally:
        pesto_model.fused_edge_attention = fused
    return res


def phase_parallel(dev, tmp):
    """Phase 10: the multi-device paths at full width (i_v4_1, 32 layers,
    seeded random weights) on the card(s): the edge kernel on shards of a
    table; data-parallel training in spawned ranks (NCCL at world size 1,
    two gloo ranks sharing cuda:0, NCCL over two cards where there are two)
    against one process; DP x SP training and the batched 2-D forward on a
    [2, 2] mesh of cuda:0 (`sp_train_run`) against one device; data-parallel serving over a mesh of [cuda:0,
    cuda:0] (and of two cards) against one device; and one structure
    sharded 2 and 4 ways (predict_structure_sp) against predict_structure.
    Returns its numbers."""
    import statistics

    import numpy as np
    import torch

    from pesto_tpu_torch.batching import to_device
    from pesto_tpu_torch.data.loader import BucketedLoader
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.parallel import comm, make_mesh
    from pesto_tpu_torch.parallel.launch import spawn_ranks
    from pesto_tpu_torch.parallel.mesh import canonical
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.synthetic import random_structure_arrays, random_structure_record
    from pesto_tpu_torch.train import create_train_state, make_train_step

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    res = {}
    n_cards = torch.cuda.device_count()
    res["edge_shard_err"], res["edge_shard_ms"] = edge_shard_cases(dev)
    part_done("edge kernel on shards")

    # ---- data-parallel training ----------------------------------------
    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    items = [training_item(*random_structure_arrays(n_atoms=n, n_res=n // 8, seed=200 + i), 300 + i, dev)
             for i, n in enumerate(TRAIN_SIZES)]
    ds = MemoryDataset(items)
    # the single-process run of the same global batches (batch_multiple 2
    # changes no batch of this plan: its batches hold 4, 2 and 2 structures)
    loader = BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH, compact=True, seed=0,
                            batch_multiple=2)
    if loader._plan() != BucketedLoader(ds, ds.sizes, atoms_per_batch=TRAIN_ATOMS_PER_BATCH, compact=True,
                                        seed=0)._plan():
        raise AssertionError("batch_multiple=2 changed phase 6's plan")
    host = list(loader)[:DP_STEPS]
    ref = {}
    for dtype in ("float32", "bfloat16"):
        state = create_train_state(cfg.replace(dtype=dtype), DP_LR, state_dict=sd, device=dev)
        losses = []
        for b in host:
            state, _, loss = timed_step(state, make_train_step(), to_device(b, dev))
            losses.append(loss)
        ref[dtype] = dict(losses=losses, params={k: p.detach().cpu() for k, p in state.model.named_parameters()})
        del state
    torch.cuda.empty_cache()
    part_done("DP reference, one process")
    job = dict(cfg=cfg, sd=sd, items=items)
    card0 = str(canonical(dev))
    runs = [("NCCL, world size 1", 1, "nccl", card0), (f"gloo, 2 ranks sharing {card0}", 2, "gloo", card0)]
    if n_cards >= 2:
        runs.append(("NCCL, 2 cards", 2, "nccl", None))
    res["dp_train"] = {}
    for name, world, backend, device in runs:
        ranks = spawn_ranks(dp_train_rank, world, os.path.join(tmp, f"dp{world}{backend}"), args=(job,),
                            backend=backend, device=device, timeout=300)
        res["dp_train"][name] = check_dp_run(name, ranks, ref, n_layers)
        part_done(f"DP train, {name}")

    # ---- DP x SP training: structures over a mesh's rows, atoms over its columns
    sp_meshes = [(f"[2, 2] of {card0}", make_mesh(2, 2, devices=[card0] * 4))]
    if n_cards >= 2:
        sp_meshes.append(("[1, 2] over cuda:0, cuda:1", make_mesh(1, 2, devices=["cuda:0", "cuda:1"])))
    res["sp_train"] = {}
    for name, mesh in sp_meshes:
        res["sp_train"][name] = sp_train_run(name, mesh, cfg, sd, host, ref, dev)
        part_done(f"DP x SP train, {name}")

    # ---- data-parallel serving -----------------------------------------
    n_big, n_atoms, n_res = HEADLINE
    big = [random_structure_record(n_atoms=n_atoms, n_res=n_res, seed=800 + i) for i in range(n_big)]
    single = Predictor(cfg, sd, device=dev)
    want = single.predict_batch(big)
    meshes = [(f"[{card0}, {card0}]", [card0, card0])]
    if n_cards >= 2:
        meshes.append(("[cuda:0, cuda:1]", ["cuda:0", "cuda:1"]))
    res["dp_serve"] = {}
    for name, devices in meshes:
        pred = Predictor(cfg, sd, mesh=make_mesh(2, 1, devices=devices))
        pred.warmup(buckets=[(8192, 1024)], batch_sizes=(4,))
        torch.cuda.synchronize()
        reset_launches()
        comm.reset()
        got = pred.predict_batch(big)
        torch.cuda.synchronize()
        launches, collectives = read_launches(), comm.total()
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        times = []
        for _ in range(HEADLINE_RUNS):
            t0 = time.perf_counter()
            pred.predict_batch(big)
            times.append(time.perf_counter() - t0)
        s = statistics.median(times)
        n_parts = expected_parts(big, len(devices))
        log(f"DP serve, mesh {name}: {n_big} x {n_atoms} atoms, max abs diff to one device {err:.3g} (atol "
            f"{DP_SERVE_TOL}); launches {launches} (expect {n_parts} kNN, {n_parts * n_layers} edge: one kNN "
            f"and {n_layers} edge per device part), collectives {collectives}; {n_big * n_atoms / s:.0f} "
            f"atoms/s (median of {HEADLINE_RUNS}: {', '.join(f'{1e3 * t:.1f}' for t in times)} ms; not a "
            f"scaling figure{': both parts on one card' if len(set(devices)) == 1 else ''})")
        if not (err <= DP_SERVE_TOL and launches == {"knn": n_parts, "edge": n_parts * n_layers}
                and collectives == 0):
            raise AssertionError(f"DP serve {name}: err {err}, launches {launches}, collectives {collectives}")
        res["dp_serve"][name] = dict(err=err, launches=launches, atoms_per_s=n_big * n_atoms / s, ms=times)
        del pred
    del single
    torch.cuda.empty_cache()
    part_done("DP serving")

    # ---- one structure, its atoms sharded ------------------------------
    pred = Predictor(cfg, sd, device=dev)
    res["sp_serve"] = {}
    for n_atoms, n_res, seed, shard_counts, with_reference in SP_STRUCTURES:
        rec = random_structure_record(n_atoms=n_atoms, n_res=n_res, seed=seed)
        n_res = len(np.unique(rec["resid"]))
        na, nr = bucket_of(rec)
        dense_gb = na * nr * 8 * 4 / 1e9  # the [NA, NR, 2Nh] fp32 softmax of one device
        ref_p = None
        if with_reference:
            pred.predict_structure(dict(rec))  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ref_p = pred.predict_structure(dict(rec))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"SP serve {n_atoms} atoms, one device (predict_structure): {ms:.1f} ms (host clock, after a "
                f"warm call), peak {peak:.2f} GiB (the dense pool softmax alone {dense_gb:.2f} GB)")
            res["sp_serve"][f"{n_atoms} atoms, one device"] = dict(ms=ms, peak_gib=peak, dense_gb=dense_gb)
        for w in shard_counts:
            mesh = make_mesh(1, w, devices=[card0] * w)
            key = f"{n_atoms} atoms, {w} shards"
            try:
                pred.predict_structure_sp(dict(rec), mesh)  # warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                comm.reset()
                t0 = time.perf_counter()
                got = pred.predict_structure_sp(dict(rec), mesh)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError as e:
                if ref_p is not None:
                    raise
                log(f"SP serve {key}: out of memory ({str(e).splitlines()[0]}); the dense pool softmax of "
                    f"one device would be {dense_gb:.2f} GB")
                res["sp_serve"][key] = dict(oom=True, dense_gb=dense_gb)
                torch.cuda.empty_cache()
                continue
            launches, collectives = read_launches(), comm.counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            finite = bool(np.isfinite(got).all()) and got.shape == (n_res, 5)
            err = float(np.abs(got - ref_p).max()) if ref_p is not None else None
            log(f"SP serve {key} on {card0}: {ms:.1f} ms per structure (host clock, after a warm call), peak "
                f"{peak:.2f} GiB for all {w} shards on one card (dense pool softmax of one device "
                f"{dense_gb:.2f} GB; not a scaling figure), launches {launches} (expect 1 kNN, "
                f"{n_layers * w} edge), collectives {collectives}, "
                + (f"max abs diff to predict_structure {err:.3g} (atol {SP_PROB_ATOL})" if err is not None
                   else "no one-device reference at this size"))
            if not (finite and launches == {"knn": 1, "edge": n_layers * w}
                    and (err is None or err <= SP_PROB_ATOL)):
                raise AssertionError(f"SP serve {key}: err {err}, launches {launches}, finite {finite}")
            res["sp_serve"][key] = dict(ms=ms, peak_gib=peak, err=err, launches=launches, dense_gb=dense_gb)
        torch.cuda.empty_cache()
    part_done("SP serving")
    log(f"phase 10 parts (s): {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    res["parts_s"] = parts
    return res


def expected_parts(recs, ndev, atoms_per_call=32768):
    """The device parts predict_batch makes of recs over a mesh of ndev
    data devices: per bucket, chunks of at most ndev * atoms_per_call // na
    structures (a multiple of ndev), each split in ndev parts."""
    import collections

    parts = 0
    for (na, _), n in collections.Counter(bucket_of(r) for r in recs).items():
        bmax = max(ndev, atoms_per_call * ndev // na)
        bmax -= bmax % ndev
        parts += -(-n // bmax) * ndev
    return parts


# ---------------------------------------------------------------- phase 11

NATIVE_REPS = 5  # parses of each file by each reader; the median is logged
# (atoms, residues) of the interfaceome records, seeds 1100 + i; one record
# past the largest bucket beside them
APPS_RECORDS = ((1024, 128), (1500, 190), (2048, 256), (2500, 310), (3000, 375), (3500, 440),
                (4095, 512), (5000, 625), (6000, 750), (7000, 875), (8191, 1024))
APPS_PROB_ATOL = 1e-5  # card vs CPU, fp32: the PPI and MaSIF benchmarks' probabilities
APPS_AUC_ATOL = 1e-4   # and their AUCs
APPS_BATCH_ATOL = 1e-6  # predict_records against predict_batch on the same records
# (bucket, dtype, tolerance of the reloaded program against Predictor.logits)
EXPORT_CASES = (((8192, 1024), "float32", 1e-6), ((4096, 512), "bfloat16", 1e-2))
EXPORT_AB_REPS = 20
DISPATCH_CALLS = 200  # calls per turn of the host-cost comparison of operator and launcher
MULTIMODEL_PDB = """MODEL        1
ATOM      1  CA ASER A   1       0.000   0.000   0.000  0.50  0.00           C
ATOM      2  CA BSER A   1       9.000   0.000   0.000  0.50  0.00           C
ATOM      3  N   SER A   1       1.000   1.000   0.000  1.00 12.50           N
HETATM    4 ZN    ZN A 101       5.000   5.000   5.000  1.00 20.00          ZN
ENDMDL
MODEL        2
ATOM      5  CA ASER A   1       0.100   0.000   0.000  0.50  0.00           C
ATOM      6  CA BSER A   1       9.100   0.000   0.000  0.50  0.00           C
ATOM      7  CA  ALA A   2       1.000   0.000   0.000  1.00  0.00
ENDMDL
END
"""


def write_with_bfactors(src, dst, per_residue):
    """A copy of a PDB with each atom's B-factor (columns 61-66) set to
    per_residue(resid)."""
    with open(src) as f:
        lines = [f"{ln[:60]}{per_residue(int(ln[22:26])):6.2f}{ln[66:]}"
                 if ln.startswith(("ATOM", "HETATM")) else ln for ln in f]
    with open(dst, "w") as f:
        f.writelines(lines)


def ppi_dir(root):
    """The golden triple of the PPI benchmark: 1OL5_A_i0.pdb (its B-factors
    a committed prediction), its truth _T (residues whose B-factor is over
    the median) and a method's _M (the prediction reversed)."""
    import shutil

    import numpy as np

    from pesto_tpu_torch.io import read_pdb

    os.makedirs(root)
    s = read_pdb(GOLDEN)
    bf = {int(r): float(s["bfactor"][s["resid"] == r].max()) for r in np.unique(s["resid"])}
    thr = float(np.median(list(bf.values())))
    shutil.copy(GOLDEN, os.path.join(root, "1OL5_A_i0.pdb"))
    write_with_bfactors(GOLDEN, os.path.join(root, "1OL5_A_i0_T.pdb"), lambda r: float(bf[r] > thr))
    write_with_bfactors(GOLDEN, os.path.join(root, "1OL5_A_i0_M.pdb"), lambda r: 1.0 - bf[r])
    return root


def masif_dir(root):
    """A MaSIF-site benchmark directory of one protein: the golden as the
    predictors' PDB, a PLY mesh made from every second atom (moved 1.5 A at
    random, triangles of consecutive vertices) with fixed interface labels
    (the vertices of the first third of the residues), and the transient
    id list."""
    import shutil

    import numpy as np

    from pesto_tpu_torch.io import read_pdb
    from pesto_tpu_torch.structure import clean_structure

    s = clean_structure(read_pdb(GOLDEN))
    rng = np.random.RandomState(7)
    v = s["xyz"][::2] + 1.5 * rng.randn(len(s["xyz"][::2]), 3).astype(np.float32)
    ures = np.unique(s["resid"])
    iface = np.isin(s["resid"][::2], ures[: len(ures) // 3])
    n = len(v)
    lines = ["ply", "format ascii 1.0", f"element vertex {n}", "property float x", "property float y",
             "property float z", "property float iface", f"element face {n - 2}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{x:.4f} {y:.4f} {z:.4f} {int(c)}" for (x, y, z), c in zip(v, iface)]
    lines += [f"3 {i} {i + 1} {i + 2}" for i in range(n - 2)]
    for sub in ("ground_truth", "sppider_pred"):
        os.makedirs(os.path.join(root, sub))
    with open(os.path.join(root, "ground_truth", "1OL5_A.ply"), "w") as f:
        f.write("\n".join(lines) + "\n")
    shutil.copy(GOLDEN, os.path.join(root, "sppider_pred", "1OL5_A.pdb"))
    with open(os.path.join(root, "testing_transient.txt"), "w") as f:
        f.write("1OL5_A\n")
    return root


def same_record(name, got, want):
    """Raise unless two structure records are equal field by field, dtypes
    included."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{name}: fields {list(got)} vs {list(want)}")
    for k in want:
        if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{name}: field {k} differs ({got[k].dtype} vs {want[k].dtype})")


def phase_apps(dev, tmp):
    """The applications at full width (i_v4_1, 32 layers, seeded random
    weights): the native parser, the profiling, PPI and MaSIF benchmark
    apps, the interfaceome core and the exported programs. Returns its
    numbers."""
    import csv
    import gzip
    import statistics

    import numpy as np
    import torch

    from pesto_tpu_torch import native
    from pesto_tpu_torch.apps import benchmark_ppi, interfaceome, masif_benchmark, profiling
    from pesto_tpu_torch.batching import encode_and_pad
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.io import save_pdb
    from pesto_tpu_torch.io.pdb import _read_pdb_python
    from pesto_tpu_torch.models import get_config
    from pesto_tpu_torch.models import pesto as model_mod
    from pesto_tpu_torch.ops import edge_attention as ea
    from pesto_tpu_torch.port import init_state_dict
    from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure, split_by_chain
    from pesto_tpu_torch.synthetic import random_structure_record

    parts, t_part = {}, [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    cfg = get_config("i_v4_1")
    n_layers = len(cfg.layers)
    sd = init_state_dict(cfg, seed=0)
    ckpt = os.path.join(tmp, "i_v4_1.pt")
    torch.save(sd, ckpt)
    res = {"launches": {}}

    def launches_of(name, run, want):
        """run() with the counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = read_launches()
        res["launches"][name] = got
        log(f"{name}: launches knn {got['knn']}, edge {got['edge']} (expect {want['knn']}, {want['edge']})")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        return out

    # the native parser against the Python reader, field by field
    if not native.native_available():
        raise AssertionError(f"the native PDB parser did not build: {native.build_error()}")
    synth_path = os.path.join(tmp, "synth8191.pdb")
    save_pdb(split_by_chain(random_structure_record(n_atoms=8191, n_res=1024, seed=1)), synth_path)
    with open(synth_path, "rb") as src, gzip.open(synth_path + ".gz", "wb") as dst:
        dst.write(src.read())
    multi_path = os.path.join(tmp, "multimodel.pdb")
    with open(multi_path, "w") as f:
        f.write(MULTIMODEL_PDB)
    res["parse_ms"] = {}
    for name, path in (("1OL5", GOLDEN), ("synth8191", synth_path), ("synth8191.gz", synth_path + ".gz"),
                       ("multimodel_altloc", multi_path)):
        got, want = native.read_pdb_native(path), _read_pdb_python(path)
        same_record(name, got, want)
        ms = {}
        for reader, fn in (("native", native.read_pdb_native), ("python", _read_pdb_python)):
            ts = []
            for _ in range(NATIVE_REPS):
                t0 = time.perf_counter()
                fn(path)
                ts.append(1e3 * (time.perf_counter() - t0))
            ms[reader] = statistics.median(ts)
        res["parse_ms"][name] = ms
        log(f"parse {name}: {len(got['xyz'])} atoms, native equal to python field by field; "
            f"native {ms['native']:.2f} ms, python {ms['python']:.2f} ms "
            f"({ms['python'] / ms['native']:.1f}x), median of {NATIVE_REPS}")
    if len(native.read_pdb_native(multi_path)["xyz"]) != 5:
        raise AssertionError("multimodel: the altloc B atoms of both models must be dropped")
    pred = Predictor(cfg, sd, device=dev)
    res["read_clean_ms"] = {}
    for reader, env in (("native", None), ("python", "1")):
        if env is None:
            os.environ.pop("PESTO_NO_NATIVE", None)
        else:
            os.environ["PESTO_NO_NATIVE"] = env
        try:
            stages = time_path(pred, synth_path, 8191)
        finally:
            os.environ.pop("PESTO_NO_NATIVE", None)
        res["read_clean_ms"][reader] = stages["read_clean"]
    log(f"read_clean of synth8191: native {res['read_clean_ms']['native']:.2f} ms, "
        f"python {res['read_clean_ms']['python']:.2f} ms")
    part_done("native parser")

    # the profiling CLI (its collect_pdbs drops *_i<digit> stems: the golden
    # goes in under another name)
    golden_copy = os.path.join(tmp, "1OL5_A.pdb")
    with open(GOLDEN) as src, open(golden_copy, "w") as dst:
        dst.write(src.read())
    prof_csv = os.path.join(tmp, "profiling.csv")
    # one kNN per structure; a warm and a timed forward for each (the two
    # lie in different buckets)
    rows = launches_of("profiling", lambda: profiling.main(
        [golden_copy, synth_path, "--out", prof_csv, "--ckpt", ckpt, "--model", "i_v4_1", "--device", str(dev)]),
        {"knn": 2, "edge": 4 * n_layers})
    with open(prof_csv) as f:
        text = f.read()
    log("profiling CSV:\n" + text.strip())
    table = list(csv.DictReader(text.splitlines()))
    if [r["size"] for r in table] != ["2158", "8191"] or len(rows) != 2:
        raise AssertionError(f"profiling rows {table}")
    for r in table:
        if not all(np.isfinite(float(r[k])) and float(r[k]) > 0 for k in ("t_load", "t_process", "t_run")):
            raise AssertionError(f"profiling row {r}")
    res["profiling"] = table
    part_done("profiling")

    # the PPI benchmark, on the card and on the CPU
    d = ppi_dir(os.path.join(tmp, "ppi"))
    args = [d, "--ckpt", ckpt, "--model", "i_v4_1"]
    rows_c, probs_c = launches_of("benchmark_ppi", lambda: benchmark_ppi.main(
        args + ["--out", os.path.join(tmp, "ppi.csv"), "--device", str(dev)]), {"knn": 1, "edge": n_layers})
    rows_p, probs_p = benchmark_ppi.main(args + ["--out", os.path.join(tmp, "ppi_cpu.csv"), "--device", "cpu"])
    if [r["id"] for r in rows_c] != ["1OL5_A_i0"] or [r["id"] for r in rows_p] != ["1OL5_A_i0"]:
        raise AssertionError(f"PPI benchmark rows {rows_c} / {rows_p}")
    p_err = float(np.abs(probs_c["1OL5_A_i0"] - probs_p["1OL5_A_i0"]).max())
    auc_err = max(abs(rows_c[0][k] - rows_p[0][k]) for k in ("auc_ours", "auc_reference", "auc_M"))
    log(f"PPI benchmark: card {rows_c[0]}; card vs CPU probabilities {p_err:.3g} (atol {APPS_PROB_ATOL}), "
        f"AUCs {auc_err:.3g} (atol {APPS_AUC_ATOL})")
    if not (p_err <= APPS_PROB_ATOL and auc_err <= APPS_AUC_ATOL):
        raise AssertionError(f"PPI benchmark card vs CPU: probabilities {p_err}, AUCs {auc_err}")
    res["benchmark_ppi"] = {"row": rows_c[0], "prob_err": p_err, "auc_err": auc_err}
    part_done("benchmark_ppi")

    # the MaSIF benchmark's bench_ours, fp32 on the card and on the CPU,
    # then bf16 (its default) on the card
    bench = masif_dir(os.path.join(tmp, "masif"))
    r_c = launches_of("masif bench_ours", lambda: masif_benchmark.bench_ours(
        bench, ckpt, "i_v4_1", fast=False, device=dev), {"knn": 1, "edge": n_layers})
    r_p = masif_benchmark.bench_ours(bench, ckpt, "i_v4_1", fast=False, device="cpu")
    keys = ("auc_point_global", "auc_res_global", "auc_point_median", "auc_res_median")
    m_err = max(abs(r_c[k] - r_p[k]) for k in keys)
    r_b = masif_benchmark.bench_ours(bench, ckpt, "i_v4_1", fast=True, device=dev)
    log(f"MaSIF bench_ours: card fp32 { {k: round(r_c[k], 6) for k in keys} }, card vs CPU AUCs "
        f"{m_err:.3g} (atol {APPS_AUC_ATOL}); card bf16 { {k: round(r_b[k], 6) for k in keys} }")
    if r_c["names"] != ["1OL5_A"] or not m_err <= APPS_AUC_ATOL:
        raise AssertionError(f"MaSIF bench_ours card vs CPU: {r_c} / {r_p}")
    if not all(0.0 <= r_b[k] <= 1.0 for k in keys):
        raise AssertionError(f"MaSIF bench_ours bf16: {r_b}")
    res["masif"] = {"fp32": {k: r_c[k] for k in keys}, "auc_err": m_err, "bf16": {k: r_b[k] for k in keys}}
    part_done("masif")

    # the interfaceome's predict core over 12 records, one past the largest
    # bucket; then cluster and analyze of its results
    records = {f"synth{n}": random_structure_record(n_atoms=n, n_res=r, seed=1100 + i)
               for i, (n, r) in enumerate(APPS_RECORDS)}
    records[f"over{OVER_BUCKET_ATOMS}"] = random_structure_record(
        n_atoms=OVER_BUCKET_ATOMS, n_res=OVER_BUCKET_ATOMS // 8, seed=1199)
    structures = [concatenate_chains(preprocess_structure(r)) for r in records.values()]
    n_chunks, _ = expected_chunks(structures[:-1])
    pred.predict_batch(structures[:1])  # warm
    t0 = time.perf_counter()
    got = launches_of("interfaceome predict_records", lambda: interfaceome.predict_records(pred, records),
                      {"knn": n_chunks, "edge": n_layers * n_chunks})
    wall = time.perf_counter() - t0
    want = pred.predict_batch(structures)
    if sorted(got) != sorted(list(records)[:-1]) or want[-1] is not None:
        raise AssertionError(f"interfaceome: predicted {sorted(got)}; the over-bucket record must be skipped")
    i_err = max(float(np.abs(got[k] - w).max()) for k, w in zip(records, want[:-1]))
    log(f"interfaceome: {len(got)} of {len(records)} records in {n_chunks} chunks, {wall * 1e3:.1f} ms "
        f"(parse-free: the records are in memory); against predict_batch {i_err:.3g} "
        f"(atol {APPS_BATCH_ATOL})")
    if not i_err <= APPS_BATCH_ATOL:
        raise AssertionError(f"interfaceome against predict_batch: {i_err}")
    entries = {k: interfaceome.aggregate_entry(records[k], p, k) for k, p in got.items()}
    if any(e is None for e in entries.values()):
        raise AssertionError("interfaceome: a residue table does not match its probabilities")
    ifaces = interfaceome.cluster_entries(entries, afs_thr=-1.0, p_thr=0.5)
    report = interfaceome.analyze_entries(entries, ifaces, p_thr=0.5)
    if not ({"coverage", "residue_propensity", "ss_propensity"} <= set(report)
            and len(report["residue_propensity"]) == cfg.dm_n2):
        raise AssertionError(f"interfaceome analyze: report keys {sorted(report)}")
    patches = [sum(len(v[c]) for v in ifaces.values()) for c in range(cfg.dm_n2)]
    log(f"interfaceome cluster: patches per class {patches}; analyze: coverage {report['coverage']}")
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("interfaceome pack and aggregate (HDF5) not run: no h5py on this machine")
    else:
        store, pred_h5, agg = (os.path.join(tmp, f) for f in ("store.h5", "pred.h5", "agg.h5"))
        interfaceome.main(["pack", golden_copy, synth_path, "--out", store])
        interfaceome.main(["predict", store, "--out", pred_h5, "--ckpt", ckpt, "--model", "i_v4_1",
                           "--device", str(dev)])
        interfaceome.main(["aggregate", store, pred_h5, "--out", agg])
        log("interfaceome pack, predict and aggregate (HDF5) ran")
    res["interfaceome"] = {"records": len(records), "predicted": len(got), "chunks": n_chunks,
                           "ms": wall * 1e3, "max_abs_err": i_err, "patches": patches}
    part_done("interfaceome")

    # the exported programs: the operator in each graph, one counted edge
    # launch per layer, the reloaded logits against the live ones, and the
    # forward's time beside the eager one's
    res["export"] = {}
    edge_op = torch.ops.pesto_tpu_torch.edge_attention.default
    for (na, nr), dtype, tol in EXPORT_CASES:
        p = Predictor(cfg.replace(dtype=dtype), sd, device=dev)
        path = os.path.join(tmp, f"exported_{dtype}.pt")
        t0 = time.perf_counter()
        p.export_compiled(path, buckets=((na, nr),))
        export_s = time.perf_counter() - t0
        program = Predictor.load_exported(path)[(na, nr)]
        n_ops = sum(n.target is edge_op for n in program.graph.nodes)
        if n_ops != n_layers:
            raise AssertionError(f"exported {dtype}: {n_ops} edge operator nodes, expected {n_layers}")
        rec = (random_structure_record(n_atoms=8191, n_res=1024, seed=1) if na == 8192
               else random_structure_record(n_atoms=na - 96, n_res=nr - 12, seed=1201))
        ps = encode_and_pad(concatenate_chains(preprocess_structure(rec)), feature_flags=cfg.feature_flags,
                            device=dev)
        if (ps.X.shape[0], ps.M.shape[1]) != (na, nr):
            raise AssertionError(f"exported {dtype}: the structure lies in {ps.X.shape[0]}x{ps.M.shape[1]}")
        args = (p._tensor(ps.X, torch.float32), p._tensor(ps.ids_topk), p._tensor(ps.q), p._tensor(ps.M),
                p._tensor(ps.atom_mask, torch.float32))
        with torch.no_grad():
            z = launches_of(f"exported {dtype} {na}x{nr}", lambda: program(*args), {"knn": 0, "edge": n_layers})
            live = p.logits(ps)
            err = float((z.float() - live.float()).abs().max())
            ms = {"exported": cuda_time_ms(lambda: program(*args), reps=EXPORT_AB_REPS),
                  "eager": cuda_time_ms(lambda: p.model(*args), reps=EXPORT_AB_REPS)}
            # one call of each under torch.profiler: (wall ms, device busy
            # ms, device operations), and the program's graph nodes
            ms["profiled"] = {"exported": profile_call(lambda: program(*args)),
                              "eager": profile_call(lambda: p.model(*args))}
            ms["graph_calls"] = sum(n.op == "call_function" for n in program.graph.nodes)
            if dtype == "float32":
                # the eager forward as shipped (the launcher called
                # directly) against one routed through the operator, in turns
                def through_operator(*a, S=32, Nh=2, Nk=3, row0=0):
                    return ea.edge_attention_op(*a, S, Nh, Nk, row0)

                shipped = model_mod.fused_edge_attention
                turns = []
                for route in ("operator", "launcher", "launcher", "operator") * 2:
                    model_mod.fused_edge_attention = through_operator if route == "operator" else shipped
                    try:
                        turns.append((route, cuda_time_ms(lambda: p.model(*args), reps=EXPORT_AB_REPS)))
                    finally:
                        model_mod.fused_edge_attention = shipped
                ms["eager_ab"] = turns
                # the host cost of one call through the operator and of the
                # launcher itself, on a layer small enough (256 atoms) that
                # the host's enqueue, not the card, paces the loop
                small = edge_inputs(256, 64, torch.float32, dev, seed=5)
                calls = {"operator": lambda: ea.edge_attention_op(*small, 32, 2, 3, 0),
                         "launcher": lambda: ea.edge_attention_kernel(*small, 32, 2, 3, 0)}
                us = {k: [] for k in calls}
                for route in ("operator", "launcher", "launcher", "operator") * 2:
                    calls[route]()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(DISPATCH_CALLS):
                        calls[route]()
                    us[route].append(1e6 * (time.perf_counter() - t0) / DISPATCH_CALLS)
                    torch.cuda.synchronize()
                ms["dispatch_us"] = us
        log(f"exported {dtype} {na}x{nr}: export + save {export_s:.1f} s, {n_ops} operator nodes; logits vs "
            f"Predictor.logits {err:.3g} (atol {tol}); forward exported {ms['exported']:.2f} ms, eager "
            f"{ms['eager']:.2f} ms (CUDA events, mean of {EXPORT_AB_REPS}); profiled (wall, busy ms, "
            f"device ops) exported {tuple(round(x, 2) for x in ms['profiled']['exported'])}, eager "
            f"{tuple(round(x, 2) for x in ms['profiled']['eager'])}; {ms['graph_calls']} graph calls"
            + (f"; eager in turns: {', '.join(f'{r} {t:.2f}' for r, t in ms['eager_ab'])} ms; host us "
               f"per call at 256 atoms: operator {[round(u, 1) for u in ms['dispatch_us']['operator']]}, "
               f"launcher {[round(u, 1) for u in ms['dispatch_us']['launcher']]}"
               if "eager_ab" in ms else ""))
        if not (z.shape == live.shape and torch.isfinite(z).all() and err <= tol):
            raise AssertionError(f"exported {dtype}: logits differ from Predictor.logits by {err}")
        res["export"][dtype] = {"bucket": [na, nr], "export_s": export_s, "max_abs_err": err, **ms}
    part_done("export")
    log("phase 11 parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    res["parts_s"] = parts
    return res

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

    log(f"build: {_build.build_all():.1f} s (all five sources, nvcc in parallel)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # the native PDB parser is required here: every later phase reads
    # through it, and phase 11 holds it against the Python reader
    from pesto_tpu_torch import native

    t0 = time.perf_counter()
    if not native.native_available():
        raise RuntimeError(f"the native PDB parser did not build: {native.build_error()}")
    log(f"native parser: built and loaded in {time.perf_counter() - t0:.1f} s ({native._target()})")

    knn_dev, knn_t = phase_knn(dev)
    edge_err, edge_t = phase_edge(dev)
    bwd_err, bwd_abs, bwd_t = phase_edge_bwd(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, prob_err, e2e = phase_main(dev, tmp)
    log(f"1OL5 GPU-vs-CPU probability deviation {prob_err:.3g}")
    off_path = phase_off_path(dev)
    script_launches = run_scripts()
    t6 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_train(dev, tmp)
    log(f"phase 6 (training) in {time.perf_counter() - t6:.1f} s")
    log(f"training: {json.dumps(train)}")
    t7 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        serving = phase_serve(dev, tmp)
    log(f"phase 7 (serving) in {time.perf_counter() - t7:.1f} s")
    log(f"serving: {json.dumps(serving)}")
    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dataset = phase_build(dev, tmp, card)
    log(f"phase 8 (dataset) in {time.perf_counter() - t8:.1f} s")
    log(f"dataset: {json.dumps(dataset, default=float)}")
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trajectories = phase_traj(dev, tmp)
    log(f"phase 9 (trajectories and the dimer model) in {time.perf_counter() - t9:.1f} s")
    log(f"trajectories: {json.dumps(trajectories, default=float)}")
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        parallel = phase_parallel(dev, tmp)
    log(f"phase 10 (multi-device paths) in {time.perf_counter() - t10:.1f} s")
    log(f"parallel: {json.dumps(parallel, default=str)}")
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        apps = phase_apps(dev, tmp)
    log(f"phase 11 (applications) in {time.perf_counter() - t11:.1f} s")
    log(f"apps: {json.dumps(apps, default=float)}")

    knn_main = knn_t["main path 8191@8192"]
    e_ms, e_pms, e_bound, e_host = edge_t[(64, torch.float32)]
    kernels = [
        {
            "name": "knn_top64", "route": "cuda", "source": "pesto_tpu_torch/csrc/knn.cu",
            "replaces": "pesto_tpu/ops/knn_pallas.py:177", "launches": launches["knn"],
            "max_abs_err": max(knn_dev, serving["chunk_kernels"]["knn_dev"], dataset["knn_dev"]),
            "ms": knn_main["ms"], "plain_ms": knn_main["plain_ms"],
            # 8 fp32 operations per pair the kernel evaluates (dot 5, Gram
            # 3); 16 B in and 64 x (4 B id + 1 B ok) out per row
            **bound(8 * knn_main["pairs"], knn_main["rows"] * (16 + 64 * 5)), "library_ms": None,
            "host_us": knn_main["host_us"],
        },
        {
            "name": "edge_attention", "route": "cuda",
            "source": "pesto_tpu_torch/csrc/edge_attention.cu",
            "replaces": "pesto_tpu/ops/geometric_pallas.py:257", "launches": launches["edge"],
            "max_abs_err": max(edge_err[torch.float32], serving["chunk_kernels"]["edge_fp32"],
                               *trajectories["edge_errs"].values(),
                               parallel["edge_shard_err"]["float32"]), "ms": e_ms, "plain_ms": e_pms,
            **e_bound, "library_ms": None, "host_us": e_host,
        },
    ]
    # the launches of phase 10's paths, each read just after it ran
    for k, key in zip(kernels[:2], ("knn", "edge")):
        k["launches_phase10"] = {
            **{f"dp_train {n} {dtype}": r[dtype]["launches"][key]
               for n, r in parallel["dp_train"].items() for dtype in ("float32", "bfloat16")},
            **{f"dp_serve {n}": r["launches"][key] for n, r in parallel["dp_serve"].items()},
            **{f"sp_serve {n}": r["launches"][key] for n, r in parallel["sp_serve"].items() if "launches" in r},
            **{f"sp_train {n} {dtype}": sum(x[key] for x in r[dtype]["launches_per_step"])
               for n, r in parallel["sp_train"].items() for dtype in ("float32", "bfloat16")},
            **{f"sp_forward {n}": r["forward"]["launches"][key] for n, r in parallel["sp_train"].items()}}
        # and of phase 11's paths, the exported programs' included
        k["launches_phase11"] = {name: counts[key] for name, counts in apps["launches"].items()}
    b32 = bwd_t[torch.float32]
    kernels.append({
        "name": "edge_attention_bwd", "route": "cuda", "source": "pesto_tpu_torch/csrc/edge_attention_bwd.cu",
        "replaces": "the plain recompute in EdgeAttentionFunction.backward (pesto_tpu_torch/ops/"
                    "edge_attention.py); the TPU kernel pesto_tpu/ops/geometric_pallas.py:257 has no backward",
        # the training path's (phase 6, fp32 steps, counts set to 0 just before)
        "launches": train["float32 launches"]["edge_bwd"], "max_abs_err": bwd_abs,
        "max_rel_l2": {str(dt)[6:]: e for dt, e in bwd_err.items()},
        "ms": b32["ms"], "plain_ms": b32["plain_ms"], **b32["bound"], "library_ms": None,
        "host_us": b32["host_us"], "device_ms": b32["device_ms"], "bf16_ms": bwd_t[torch.bfloat16]["ms"],
        "bf16_bound_ms": bwd_t[torch.bfloat16]["bound"]["bound_ms"], "weight_grads_bit_identical": True,
        "ptxas": ptxas_report(_build.build_logs.get("edge_attention_bwd", "")),
        "launches_per_phase": {
            **{f"phase6 train {dtype}": train[f"{dtype} launches"]["edge_bwd"] for dtype in ("float32", "bfloat16")},
            **{f"phase6 eval {dtype}": train[f"{dtype} launches"]["eval_edge_bwd"]
               for dtype in ("float32", "bfloat16")},
            "phase9 cross": trajectories["cross"]["bwd_launches"],
            **{f"phase10 dp_train {n} {dtype}": r[dtype]["bwd_launches"]
               for n, r in parallel["dp_train"].items() for dtype in ("float32", "bfloat16")},
            **{f"phase10 sp_train {n} {dtype}": sum(r[dtype]["bwd_launches_per_step"])
               for n, r in parallel["sp_train"].items() for dtype in ("float32", "bfloat16")}},
    })
    kernels += [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": script_launches[name], **off_path[name]}
        for name, (source, replaces) in OFF_PATH.items()
    ]
    log("kernel shapes: knn_top64 at the 8191-atom structure (NA=8192), the ids-only entry "
        "of the main path, bound from the pairs it evaluated; "
        "edge_attention fp32 at N=8192, nn=64 (bound: 3xTF32 on the tensor cores); "
        "edge_attention_bwd fp32 at N=8192, nn=64 (bound: 3xTF32), its launches those of phase 6's fp32 "
        "train steps; "
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
