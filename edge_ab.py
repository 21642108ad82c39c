"""An edge-attention kernel of this checkout beside another checkout's, on
the card, for a change to the kernel:

    python3 edge_ab.py --other DIR [--tolerance] [--reps 20]
    python3 edge_ab.py --backward --other DIR [--reps 20]

DIR is another checkout of the repository (a parent commit unpacked with
`git archive`). The default mode builds both checkouts'
`csrc/edge_attention.cu` and runs them on chip_smoke.py's seeded phase-3
inputs (N = 8192 at nn 8, 16, 32 and 64, N = 32768 at nn 8 and 64, fp32
and bf16; the other's wrapper is called with its own arguments, so row0 =
0 here): their outputs compared bit for bit, and each kernel's warm time
taken in turns (other, this, this, other) by CUDA events. Exits 1 if any
output differs. With `--tolerance`, for a kernel whose sums run in
another order, each kernel is instead held to phase 3's tolerance against
the plain version (FP32_TOL, BF16_TOL), and exits 1 if either is beyond
it; whether the outputs are bit for bit equal is still reported.

`--backward` does the same for `csrc/edge_attention_bwd.cu` on phase 3's
seeded backward inputs (`chip_smoke.edge_bwd_case`), at N = 8192 for nn 8,
16, 32 and 64 and at N = 16384 for nn 8 and 64, fp32 and bf16. The table
gradient's atomic adds change order from run to run, so the two are held
to phase 3's tolerances, not bit for bit: in fp32 each one's per-tensor
relative L2 against the plain backward at most EDGE_BWD_RTOL; in bf16 each
one's error against the fp32 plain backward of the same inputs at most
EDGE_BWD_BF16_RATIO times the plain bf16 backward's. Exits 1 if either
is beyond them. Each mode prints one JSON line, with the card's name and
power limit.
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys


def load_other(root):
    """The other checkout's `pesto_tpu_torch.ops.edge_attention`, imported
    under another package name so that both live in this process."""
    name = "other_pesto_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "pesto_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.edge_attention")


FORWARD_CASES = ((8192, 8), (8192, 16), (8192, 32), (8192, 64), (32768, 8), (32768, 64))


def excess(got, want, tol):
    """The largest amount by which an output of `got` lies beyond tol of
    `want` (inf if it is not finite); <= 0 within it."""
    worst = float("-inf")
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not a.isfinite().all():
            return float("inf")
        worst = max(worst, ((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs()).max().item())
    return worst


def forward_ab(other, ea, dev, reps, tolerance):
    """(rows, ok) of the forward kernels: ok is every output bit for bit
    equal or, with `tolerance`, both kernels within phase 3's tolerance of
    the plain version."""
    import torch

    from chip_smoke import BF16_TOL, FP32_TOL, cuda_time_ms, edge_inputs

    rows, ok = [], True
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for N, nn in FORWARD_CASES:
            x = edge_inputs(N, nn, dt, dev, seed=nn * 7 + N)
            a, b = other.edge_attention_kernel(*x), ea.edge_attention_kernel(*x)
            torch.cuda.synchronize()
            bits = all(torch.equal(p, q) for p, q in zip(a, b))
            plain = ea.edge_attention_plain(*x)
            err = {"other": excess(a, plain, tol), "this": excess(b, plain, tol)}
            del a, b, plain
            ok &= all(e <= 0 for e in err.values()) if tolerance else bits
            t = [cuda_time_ms(lambda k=k: k.edge_attention_kernel(*x), reps=reps)
                 for k in (other, ea, ea, other)]
            rows.append({"dtype": str(dt)[6:], "N": N, "nn": nn, "bits_equal": bits, "tol": tol,
                         "other_excess": err["other"], "this_excess": err["this"],
                         "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]})
            print(f"edge N={N} nn={nn} {str(dt)[6:]}: bits {'equal' if bits else 'differ'}; beyond "
                  f"tolerance of the plain version by other {err['other']:.3g}, this {err['this']:.3g} "
                  f"(<= 0 within); other {t[0]:.4f}, {t[3]:.4f} ms; this {t[1]:.4f}, {t[2]:.4f} ms; "
                  f"x{(t[0] + t[3]) / (t[1] + t[2]):.3f}", flush=True)
    return rows, ok


def backward_ab(other, ea, dev, reps):
    """(rows, both within phase 3's tolerances) of the backward kernels."""
    import torch

    from chip_smoke import (EDGE_BWD_BF16_RATIO, EDGE_BWD_RTOL, PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, bound,
                            cuda_time_ms, edge_bwd_case, edge_bwd_cost, rel_errors)

    rows, ok = [], True
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        for i, (N, nn) in enumerate([(8192, 8), (8192, 16), (8192, 32), (8192, 64), (16384, 8), (16384, 64)]):
            args, gzq, gzp = edge_bwd_case(N, nn, dt, dev, seed=101 + 7 * i)
            got = {"other": other.edge_attention_backward_kernel(*args, gzq, gzp),
                   "this": ea.edge_attention_backward_kernel(*args, gzq, gzp)}
            if bf16:
                up = [a.float() if a.is_floating_point() else a for a in args]
                ref = ea.edge_attention_backward_plain(*up, gzq.float(), gzp.float())
                e_plain = rel_errors(ea.edge_attention_backward_plain(*args, gzq, gzp), ref)
                err = {k: max(e / p if p else (0.0 if e == 0 else float("inf"))
                              for e, p in zip(rel_errors(g, ref), e_plain)) for k, g in got.items()}
                tol = EDGE_BWD_BF16_RATIO
            else:
                ref = ea.edge_attention_backward_plain(*args, gzq, gzp)
                err = {k: max(rel_errors(g, ref)) for k, g in got.items()}
                tol = EDGE_BWD_RTOL
            del got, ref
            torch.cuda.synchronize()
            within = all(e <= tol for e in err.values())
            ok &= within
            t = [cuda_time_ms(lambda k=k: k.edge_attention_backward_kernel(*args, gzq, gzp), reps=reps)
                 for k in (other, ea, ea, other)]
            flops, nbytes = edge_bwd_cost(N, nn, 2 if bf16 else 4)
            lim = bound(flops, nbytes, PEAK_BF16_FLOPS) if bf16 else bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            what = "ratio to the plain bf16 backward's error" if bf16 else "rel L2 against the plain backward"
            rows.append({"dtype": str(dt)[6:], "N": N, "nn": nn, "error": what, "tol": tol, "other_err": err["other"],
                         "this_err": err["this"], "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "bound_ms": lim["bound_ms"], "bound_by": lim["bound_by"]})
            print(f"edge backward N={N} nn={nn} {str(dt)[6:]}: {what} other {err['other']:.3g}, this "
                  f"{err['this']:.3g} (tol {tol}); other {t[0]:.4f}, {t[3]:.4f} ms; this {t[1]:.4f}, {t[2]:.4f} ms; "
                  f"bound {lim['bound_ms']:.4f} ms", flush=True)
    return rows, ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--other", required=True, help="another checkout of the repository")
    parser.add_argument("--backward", action="store_true", help="the backward kernels, not the forward ones")
    parser.add_argument("--tolerance", action="store_true",
                        help="forward: hold both kernels to phase 3's tolerance, not to each other's bits")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)

    from chip_smoke import card_line, ptxas_report
    from pesto_tpu_torch.device import resolve_device
    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.ops import edge_attention as ea

    dev = resolve_device("cuda")
    other = load_other(args.other)
    if args.backward:
        _build.build_all(("edge_attention_bwd",))
        for line in ptxas_report(_build.build_logs.get("edge_attention_bwd", "")):
            print(f"this edge_attention_bwd ptxas: {line}", flush=True)
        rows, ok = backward_ab(other, ea, dev, args.reps)
    else:
        _build.build_all(("edge_attention",))
        for line in ptxas_report(_build.build_logs.get("edge_attention", "")):
            print(f"this edge_attention ptxas: {line}", flush=True)
        rows, ok = forward_ab(other, ea, dev, args.reps, args.tolerance)
    print(json.dumps({"device": card_line(), "mode": "backward" if args.backward else "forward", "cases": rows}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
