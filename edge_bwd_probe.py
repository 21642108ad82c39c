#!/usr/bin/env python3
"""Where the edge backward kernel's tile loop spends its time, on the card.

    python3 edge_bwd_probe.py [--n 8192] [--nn 64] [--reps 5]

Builds a copy of pesto_tpu_torch/csrc/edge_attention_bwd.cu in which
thread 0 of every block of the tile kernel reads clock64() after each
barrier it waits at (the block's, `sync_all` and the `__syncthreads_or`
vote, and its group's named barrier, `sync_group`) and adds the cycles
since the previous one to a per-barrier counter, swaps that library in
for the wrapper, and runs the backward at N atoms and nn neighbours on
seeded inputs, fp32 and bf16. Prints the card's name and power limit,
then per dtype the cycles per tile of each span between two barriers
(summed over the blocks, divided by the tiles), labelled by the `// ----`
section comment above the barrier that ends it, and the kernel's time by
CUDA events with and without the probe. A block's barrier waits for every
warp, so its span is the time of the slowest warp; a group's barrier
waits for the 4 warps of thread 0's group. Needs one CUDA card; run it
from the root of the repository.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "pesto_tpu_torch", "csrc", "edge_attention_bwd.cu")
SPANS = 64


def probed_source(src):
    """(the source with a clock64 mark after each barrier of the tile
    kernel and, before it, each warp's busy cycles since the last one it
    passed; the label of each mark)."""
    start = src.index("edge_bwd_tile(const Args<T> g)")
    start = src.rindex("template <typename T>", 0, start)
    end = src.index("template <typename T>", src.index("edge_bwd_tile(const Args<T> g)"))
    body, labels, title = src[start:end], [], "start of the tile"
    out, pos = [], 0
    barrier = r"\bsync_all\(\);|\bsync_group\([^;]*\);|__syncthreads_or\([^;]*\);"
    for m in re.finditer(r"// ---- (.*?)[ -]*$|" + barrier, body, re.M):
        if m.group(1):
            title = m.group(1).strip()
            continue
        labels.append(title)
        k = len(labels)
        line = body.rindex("\n", 0, m.start()) + 1
        indent = line + len(body[line:]) - len(body[line:].lstrip(" "))
        out.append(body[pos:indent] + f"ARRIVE({k}); " + body[indent:m.end()] + f" MARK({k});")
        pos = m.end()
    body = "".join(out) + body[pos:]
    body = body.replace("float gk0[8][4] = {}", "long long last = clock64(), rel = last;\n  float gk0[8][4] = {}", 1)
    head = src[:start].replace(
        "namespace {",
        "namespace {\n__device__ unsigned long long g_spans[%d], g_busy[%d][32];\n"
        "#define MARK(k) do { const long long now = clock64(); if (threadIdx.x == 0) { "
        "atomicAdd(&g_spans[k], (unsigned long long)(now - last)); last = now; } rel = now; } while (0)\n"
        "#define ARRIVE(k) do { if ((threadIdx.x & 31) == 0) atomicAdd(&g_busy[k][threadIdx.x >> 5], "
        "(unsigned long long)(clock64() - rel)); } while (0)\n" % (SPANS, SPANS), 1)
    tail = ('\nextern "C" int read_spans(void* out) { return (int)cudaMemcpyFromSymbol(out, g_spans, '
            'sizeof(g_spans)); }\nextern "C" int read_busy(void* out) { return (int)cudaMemcpyFromSymbol(out, '
            'g_busy, sizeof(g_busy)); }\nextern "C" int reset_spans() { static unsigned long long z[%d * 33]; '
            'int e = (int)cudaMemcpyToSymbol(g_spans, z, sizeof(g_spans)); '
            'return e ? e : (int)cudaMemcpyToSymbol(g_busy, z, sizeof(g_busy)); }\n' % SPANS)
    return head + body + src[end:] + tail, labels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--nn", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("edge_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.ops import edge_attention as ea

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    _build.build_all(("edge_attention_bwd",))
    plain_lib = _build._libs["edge_attention_bwd"]
    for line in cs.ptxas_report(_build.build_logs.get("edge_attention_bwd", "")):
        print(f"ptxas: {line}")
    src, labels = probed_source(open(SOURCE).read())
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "libprobe.so")
        with open(cu, "w") as f:
            f.write(src)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], capture_output=True, text=True,
                           timeout=600)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        probe = ctypes.CDLL(so)

    def use(lib):
        _build._libs["edge_attention_bwd"] = lib
        for e in _build.Entry.bound:
            e._fn = None
        _build.Entry.bound.clear()

    tiles = -(-args.n // (64 // args.nn))
    for dt in (torch.float32, torch.bfloat16):
        inputs, gzq, gzp = cs.edge_bwd_case(args.n, args.nn, dt, dev, seed=5)

        def run():
            return ea.edge_attention_backward_kernel(*inputs, gzq, gzp)

        use(plain_lib)
        plain_ms = cs.cuda_time_ms(run, reps=args.reps)
        use(probe)
        probed_ms = cs.cuda_time_ms(run, reps=args.reps)
        probe.reset_spans()
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
        spans = (ctypes.c_ulonglong * SPANS)()
        busy = (ctypes.c_ulonglong * (SPANS * 32))()
        probe.read_spans(spans)
        probe.read_busy(busy)
        per_tile = [spans[k + 1] / args.reps / tiles for k in range(len(labels))]
        total = sum(per_tile)
        print(f"{str(dt)[6:]} N={args.n} nn={args.nn}: kernel {plain_ms:.4f} ms ({probed_ms:.4f} ms probed); "
              f"{total:.0f} cycles per tile of 64 edges, by the span ending at each barrier (thread 0's), "
              "and the warps' busy cycles in it (from the last barrier each passed to its arrival: "
              "min / mean / max over the warps that wait there):", flush=True)
        for k, (label, c) in enumerate(zip(labels, per_tile), 1):
            b = [busy[k * 32 + w] / args.reps / tiles for w in range(32)]
            b = [x for x in b if x > 0] or [0.0]
            print(f"  {k:2d} {label[:60]:60s} {c:9.0f}  {c / total:.3f}   busy {min(b):7.0f} "
                  f"{sum(b) / len(b):7.0f} {max(b):7.0f}")
        use(plain_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
