"""The five cases of docs/mosaic_repros.py, run through their CUDA kernels.

    python -m pesto_tpu_torch.scripts.mosaic_repros [case ...] [--device cpu]

Cases: vmem500, bf16broadcast, i1carry, bitcast0, bisecthang (default: all
five). Each case runs its two variants and prints one line per variant:
the output's sum and whether it equals the kernel's plain version bit for
bit (a NaN equal to any NaN). The last line is a JSON object of the
launches each kernel made. The exit code is 1 when a variant differs.

On the TPU each case stages a fault of the Mosaic compiler: an opaque error
from the scoped-VMEM budget, a crash on a bf16 broadcast, an i1 loop carry
that does not legalize, an unsupported rank-0 bitcast, and a compile that
hangs on the per-row bisection. None of them has a CUDA counterpart. On
Hopper every variant is an ordinary kernel, so no line here expects an
error, and bisecthang runs by default. For vmem500 the counterpart of the
VMEM budget is a block's shared memory: the default variant streams x
through a 48 KB tile, which any block gets without opting in, and the
raised variant opts in to 227 KB per block. The TPU kernel's 20 MB scratch
cannot live in shared memory; both variants compute the same output.

The inputs reach each kernel's branches: a NaN and
both infinities among the bf16broadcast rows, entries of exactly 0 and 0.5
for i1carry, a NaN with a payload for bitcast0, and for bisecthang, besides
the TPU script's |randn| rows (which never leave the bisection's first
branch), rows scaled to 1e2, 1e4 and 1e6 that do bisect.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import mosaic_repros as ops

SEED = 0
NAN_PAYLOAD = 0x7FC12345


def case_vmem500(dev, gen, shape=(4096, 1280)):
    x = torch.randn(shape, generator=gen).to(dev)
    return [
        ("scale_add", f"default {ops.SHARED_DEFAULT // 1024} KB shared-memory tile",
         lambda: ops.scale_add(x, raised=False), lambda: ops.scale_add_plain(x)),
        ("scale_add", f"raised {ops.SHARED_RAISED // 1024} KB tile (opted in)",
         lambda: ops.scale_add(x, raised=True), lambda: ops.scale_add_plain(x)),
    ]


def case_bf16broadcast(dev, gen, shape=(256, 128)):
    x = torch.randn(shape, generator=gen)
    x[5, 17], x[9, 3], x[12, 100] = float("nan"), float("inf"), float("-inf")
    out = []
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dev, dt)
        out.append(("rowmax_mul", f"{str(dt)[6:]} [A,1]*[A,S] row-max broadcast",
                    lambda xd=xd: ops.rowmax_mul(xd), lambda xd=xd: ops.rowmax_mul_plain(xd)))
    return out


def case_i1carry(dev, gen, n=8, shape=(8, 128)):
    x = torch.rand(shape, generator=gen) * 3.5 - 0.5
    x[0, :4], x[0, 4:8], x[1:, 8:12] = 0.0, 0.5, 0.5
    x, nt = x.to(dev), torch.tensor([n], dtype=torch.int32, device=dev)
    return [
        ("carry_and", f"{name} vector loop carry, n={n}",
         lambda b=as_bool: ops.carry_and(x, nt, as_bool=b), lambda: ops.carry_and_plain(x, nt))
        for name, as_bool in (("i32", False), ("bool", True))
    ]


def case_bitcast0(dev, gen, first_bits=NAN_PAYLOAD, cols=128):
    x = torch.randn((1, cols), generator=gen)
    x[0, 0] = torch.from_numpy(np.array([first_bits], np.uint32).view(np.float32))[0]
    x = x.to(dev)
    return [
        ("bitcast_first", f"rank-{rank} bitcast of 0x{first_bits:08x}",
         lambda r=rank: ops.bitcast_first(x, rank=r), lambda: ops.bitcast_first_plain(x))
        for rank in (1, 0)
    ]


def bisecting_rows(gen, shape):
    """|randn| rows scaled in turn by 1e2, 1e4 and 1e6, with two NaNs."""
    d = torch.randn(shape, generator=gen).abs()
    d *= 10.0 ** (2 + 2 * (torch.arange(shape[0]) % 3))[:, None]
    d[3, 7] = d[100, 0] = float("nan")
    return d


def bisect_mids(d):
    """[rows, BISECT_STEPS] float32: the pivots that `bisect_mask_plain`'s
    loop visits on each row of the numpy float32 array d."""
    f32 = np.float32
    lo = np.zeros(d.shape[0], f32)
    hi = np.full(d.shape[0], ops.BISECT_HI, f32)
    mids = []
    for _ in range(ops.BISECT_STEPS):
        mid = f32(0.5) * (lo + hi)
        up = (d <= mid[:, None]).sum(axis=1) < ops.BISECT_K
        lo, hi = np.where(up, mid, lo), np.where(up, hi, mid)
        mids.append(mid)
    return np.stack(mids, axis=1)


def _pivot(rng):
    """A pivot the loop visits when it goes up or down at random."""
    lo, hi = np.float32(0), np.float32(ops.BISECT_HI)
    for _ in range(rng.randint(1, ops.BISECT_STEPS + 1)):
        mid = np.float32(0.5) * (lo + hi)
        lo, hi = (mid, hi) if rng.rand() < 0.5 else (lo, mid)
    return mid


ADVERSARIAL_KINDS = ("scaled", "v64_at_pivot", "all_at_pivot", "narrow_band", "few", "all_nan",
                     "signed_zeros", "mostly_inf")


def adversarial_rows(seed, rows, cols):
    """[rows, cols] float32 numpy rows that reach the corners of the
    bisection, the kinds of ADVERSARIAL_KINDS in turn by row:

      scaled        |randn| scaled to 1e-2..1e6, with 5% NaN, some +inf,
                    -inf, -0.0, +0.0 and negatives, and up to 40 values set
                    exactly to pivots the plain loop visits on the row;
      v64_at_pivot  63 values under a visited pivot, a few exactly on it,
                    the rest above it (the 64th smallest is the pivot);
      all_at_pivot  every value the pivot (the 64th ties with all others);
      narrow_band   values within 1% above a pivot (one first digit);
      few           fewer than 64 values that are not NaN;
      all_nan       NaN only;
      signed_zeros  -0.0, +0.0, negatives and -inf with some positives;
      mostly_inf    +inf in 95% of the places, the rest positive.
    """
    rng = np.random.RandomState(seed)
    f32 = np.float32
    d = np.empty((rows, cols), f32)
    for r in range(rows):
        kind = ADVERSARIAL_KINDS[r % len(ADVERSARIAL_KINDS)]
        p = _pivot(rng)
        u = rng.rand(cols)
        if kind == "scaled":
            row = np.abs(rng.standard_normal(cols)) * 10.0 ** rng.uniform(-2, 6)
            for lo, hi, v in ((0.0, 0.05, np.nan), (0.05, 0.06, np.inf), (0.06, 0.07, -np.inf),
                              (0.07, 0.08, -0.0), (0.08, 0.09, 0.0)):
                row[(u >= lo) & (u < hi)] = v
            neg = (u >= 0.09) & (u < 0.12)
            row[neg] = -row[neg]
            row = row.astype(f32)
            mids = bisect_mids(row[None])[0]
            ties = rng.choice(cols, min(40, cols), replace=False)
            row[ties] = mids[rng.randint(0, len(mids), len(ties))]
        elif kind == "v64_at_pivot":
            row = np.where(u < 0.5, p * 1.5, np.inf).astype(f32) + f32(1.0)
            below = rng.choice(cols, min(ops.BISECT_K - 1, cols), replace=False)
            row[below] = (p * rng.rand(len(below))).astype(f32)
            rest = np.setdiff1d(np.arange(cols), below)
            row[rest[: rng.randint(1, 4)]] = p
        elif kind == "all_at_pivot":
            row = np.full(cols, p, f32)
        elif kind == "narrow_band":
            row = (p * (1.0 + 0.01 * u)).astype(f32)
        elif kind == "few":
            row = np.full(cols, np.nan, f32)
            keep = rng.choice(cols, min(ops.BISECT_K - 1 - rng.randint(0, 10), cols), replace=False)
            row[keep] = (rng.rand(len(keep)) * 2 * p).astype(f32)
        elif kind == "all_nan":
            row = np.full(cols, np.nan, f32)
        elif kind == "signed_zeros":
            row = np.choose(rng.randint(0, 5, cols), [np.full(cols, -0.0), np.zeros(cols),
                                                      -rng.rand(cols), np.full(cols, -np.inf),
                                                      rng.rand(cols) * p]).astype(f32)
        else:  # mostly_inf
            row = np.where(u < 0.95, np.inf, rng.rand(cols) * p).astype(f32)
        d[r] = row
    return d


def case_bisecthang(dev, gen, shape=(256, 512)):
    out = []
    for name, d in (("the TPU script's |randn| rows", torch.randn(shape, generator=gen).abs()),
                    ("rows scaled to 1e2/1e4/1e6", bisecting_rows(gen, shape))):
        d = d.to(dev)
        out.append(("bisect_mask", f"per-row bisection, {name}",
                    lambda d=d: ops.bisect_mask(d), lambda d=d: ops.bisect_mask_plain(d)))
    return out


CASES = {
    "vmem500": case_vmem500,
    "bf16broadcast": case_bf16broadcast,
    "i1carry": case_i1carry,
    "bitcast0": case_bitcast0,
    "bisecthang": case_bisecthang,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("cases", nargs="*", help=f"any of {', '.join(CASES)} (default: all)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.cases) - set(CASES))
    if unknown:
        parser.error(f"unknown cases {unknown}")
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(SEED)

    for k in ops.KERNELS:
        k.launches = 0
    all_same = True
    for name in args.cases or CASES:
        print(f"[{name}]")
        for _, label, run, plain in CASES[name](dev, gen):
            out, ref = run(), plain()
            same = ops.same_bits(out, ref)
            all_same &= same
            print(f"  {label}: sum={out.double().sum().item():.3f}, "
                  f"bit for bit equal to the plain version: {same}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({"launches": {k.__name__: k.launches for k in ops.KERNELS}}))
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
