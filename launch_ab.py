"""The host's cost per launch of the port's kernel wrappers, on the card,
for a change to the launch path (`pesto_tpu_torch/ops/_build.py`):

    python3 launch_ab.py [--other DIR] [--calls 1000] [--out FILE]

DIR is another checkout of the repository (a parent commit unpacked with
`git archive`). The cases are phase 5 of chip_smoke.py's timed ones, the
edge kernel at N = 8192, nn = 64 fp32 (phase 3's seeded inputs) and the
kNN kernel's ids-only entry at the synthetic 8191-atom structure (8192
rows), each wrapper called on the same inputs in every checkout, and the
library call beside a kernel (torch.gather, index_select, torch.add).
Each case is taken in turns: other, this, library, library, this, other
(without --other: this, library, library, this). Per turn:

  host_us    the host's time per call: `calls` calls (a tenth of them for
             the cases the card's time bounds) on the host clock, which
             stops before the one synchronisation at the end; median of 9;
  ms         the mean over 20 calls by CUDA events, as phase 5 times;

and, on a checkout's first turn, `pieces`: host us per call of the launch
path's parts, each the drop in host_us when one more part is stubbed out:
the C call itself (`c_call`: the C function replaced by one that returns
0), the launch mechanism (`launch`: entry lookup or object, pointers,
stream, status), the launch counter (`count`); `alloc` is the wrapper's
output allocations timed alone, and `checks` what remains (for the kNN
also its Morton sort). After every case, `device_ms`, the kernels' own
time under torch.profiler, for each checkout and library call. The host
us of the primitives that a launch path is made of are taken before the
cases and again after the profiler. Outputs of the two checkouts are
compared bit for bit. Prints a line per case and one JSON line last (also
written to FILE); exits 1 if any output differs.
"""

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.abspath(__file__))
MODULES = ("_build", "exp_gather", "mosaic_repros", "edge_attention", "knn")
REPEATS = 9  # loops per host_us, whose median is taken


def load_tree(root):
    """{module name: module} of `pesto_tpu_torch.ops` in the checkout at
    root; another checkout's package is imported under another name, so
    that both live in this process."""
    if root is None:
        return {m: importlib.import_module(f"pesto_tpu_torch.ops.{m}") for m in MODULES}
    name = "other_pesto_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "pesto_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{name}.ops.{m}") for m in MODULES}


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _zero(*args):
    return 0


class Stubs:
    """Context managers that stub one part of a checkout's launch path:
    either `_build.call` over a table of bound C functions (`_build._entries`)
    or the entry objects (`_build.Entry`)."""

    def __init__(self, b):
        self.b = b
        self.entries = hasattr(b, "Entry")

    @contextlib.contextmanager
    def c_call(self):
        b = self.b
        with contextlib.ExitStack() as stack:
            if self.entries:
                for e in b.Entry.bound:
                    if not e.host:
                        stack.enter_context(patched(e, "_fn", _zero))
            else:
                old = dict(b._entries)
                b._entries.update({k: (v[0], _zero) for k, v in old.items() if isinstance(v, tuple)})
                stack.callback(b._entries.update, old)
            yield

    def launch(self):
        if self.entries:
            real = self.b.Entry.__call__

            def stub(e, *args):
                return real(e, *args) if e.host else 0
            return patched(self.b.Entry, "__call__", stub)
        return patched(self.b, "call", _zero)

    def count(self):
        return patched(self.b, "count_launch", _zero)


def same_bits(a, b):
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def shared_runtime_lib(b):
    """csrc/exp_gather.cu built as the port builds it but against the
    shared CUDA runtime (nvcc links the static one by default), loaded."""
    out = os.path.join(b.BUILD_DIR, "libexp_gather-cudart-shared.so")
    subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-cudart", "shared", "-o", out,
                    os.path.join(b.CSRC, "exp_gather.cu")], check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(out)


def primitives(trees, dev, calls):
    """{label: [host us per call, twice]} of the operations a launch path
    is made of, in two rounds over all of them."""
    import torch

    from chip_smoke import host_us

    x = torch.rand((8, 128), device=dev)
    i = dev.index or 0
    lock = threading.Lock()
    idx = torch.randint(0, 128, (8, 128), device=dev, dtype=torch.int32)
    idx_long = idx.long()
    take_lanes_kernel = trees[0]["exp_gather"].take_lanes_kernel
    out = torch.empty_like(x)
    lib = trees[0]["_build"].load("exp_gather")
    err = lib["error_string"]
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p

    def take_lanes(dll):
        fn = dll["take_lanes"]
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    c_fn, py_fn = take_lanes(lib), take_lanes(ctypes.PyDLL(lib._name))
    shared_fn = take_lanes(shared_runtime_lib(trees[0]["_build"]))
    ptrs = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def locked():
        with lock:
            pass

    ops = {
        "torch.empty(shape, dtype, device)": lambda: torch.empty((8, 128), dtype=torch.float32, device=dev),
        "torch.empty(shape, dtype, device=x.device)": lambda: torch.empty((8, 128), dtype=torch.float32,
                                                                         device=x.device),
        "x.new_empty(shape)": lambda: x.new_empty((8, 128)),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "x.device": lambda: x.device,
        "x.get_device()": lambda: x.get_device(),
        "x.data_ptr()": lambda: x.data_ptr(),
        "x.is_cuda, dtype, dim(), is_contiguous()": lambda: (x.is_cuda and x.dtype is torch.float32
                                                              and x.dim() == 2 and x.is_contiguous()),
        "x.shape == (8, 128)": lambda: x.shape == (8, 128),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "with threading.Lock()": locked,
        "torch.empty_like(idx, dtype=torch.float32)": lambda: torch.empty_like(idx, dtype=torch.float32),
        "ctypes C call, 1 int (error_string)": lambda: err(0),
        "ctypes take_lanes, 7 args, returns before launching (rows 0)": lambda: c_fn(*ptrs, 0, 128, 128,
                                                                                   stream),
        "ctypes take_lanes, 7 args, launches [8,128]": lambda: c_fn(*ptrs, 8, 128, 128, stream),
        "ctypes.PyDLL (the GIL held) take_lanes, launches [8,128]": lambda: py_fn(*ptrs, 8, 128, 128,
                                                                                  stream),
        "ctypes take_lanes built with -cudart shared, launches [8,128]": lambda: shared_fn(
            *ptrs, 8, 128, 128, stream),
        "take_lanes_kernel [8,128]": lambda: take_lanes_kernel(x, idx),
        "torch.gather [8,128]": lambda: torch.gather(x, 1, idx_long),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        ops["torch._C._cuda_getCurrentRawStream(i)"] = lambda: torch._C._cuda_getCurrentRawStream(i)
    rounds = [{k: host_us(f, calls) for k, f in ops.items()} for _ in range(2)]
    return {k: [r[k] for r in rounds] for k in ops}


def make_cases(dev):
    """(name, label, bound by the card, kernel call given a checkout's
    modules, the wrapper's allocations {entry objects: call}, library call
    or None)."""
    import torch

    from chip_smoke import edge_inputs, main_path_inputs, padded_batch
    from pesto_tpu_torch.ops import knn
    from pesto_tpu_torch.scripts import mosaic_repros as script
    from pesto_tpu_torch.synthetic import random_structure_record

    g = torch.Generator(device=dev).manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    tab8, tab128, tab_sel, tab_main = rand(8, 128), rand(128, 128), rand(8192, 128), rand(8192, 128)
    idx8 = torch.randint(0, 128, (8, 128), generator=g, device=dev, dtype=torch.int32)
    idx_sel = torch.randint(0, 128, (8192, 64), generator=g, device=dev, dtype=torch.int32)
    idx8_long, idx_sel_long = idx8.long(), idx_sel.long()
    ids_main, dsq_main = main_path_inputs(dev)
    L = ids_main.shape[1]
    x = torch.randn((4096, 1280), generator=g, device=dev)
    one = torch.ones_like(x)
    xb16 = torch.randn((256, 128), generator=g, device=dev).bfloat16()
    xcar = rand(8, 128) * 3.5 - 0.5
    n8 = torch.tensor([8], dtype=torch.int32, device=dev)
    x1 = torch.randn((1, 128), generator=g, device=dev)
    d_small = script.bisecting_rows(gen, (256, 512)).to(dev)
    edge = edge_inputs(8192, 64, f32, dev, seed=64 * 7 + 8192)
    synth = random_structure_record(n_atoms=8191, n_res=1024, seed=1)["xyz"]
    X, m = padded_batch([synth], 8192)
    xc = knn.center_coords(torch.tensor(X, device=dev), torch.tensor(m, device=dev))
    def empty(specs, new):
        """The wrapper's output allocations, before the entry objects (each
        a `torch.empty(shape, dtype=, device=)`) and after them (`new`)."""
        return {False: lambda: [torch.empty(shape, dtype=dt, device=dev) for shape, dt in specs],
                True: new}

    i32, b8 = torch.int32, torch.bool
    edge_qp = edge[0]
    return [
        ("take_lanes", "[8,128] f32 by [8,128] ids", False,
         lambda o: o["exp_gather"].take_lanes_kernel(tab8, idx8),
         empty([((8, 128), f32)], lambda: torch.empty_like(idx8, dtype=f32)),
         lambda: torch.gather(tab8, 1, idx8_long)),
        ("take_lanes", "[8192,128] f32 by [8192,64] ids (the kNN select, exp_gather.py:122)", False,
         lambda o: o["exp_gather"].take_lanes_kernel(tab_sel, idx_sel),
         empty([((8192, 64), f32)], lambda: torch.empty_like(idx_sel, dtype=f32)),
         lambda: torch.gather(tab_sel, 1, idx_sel_long)),
        ("take_rows", "[128,128] f32 by idx[0] of [8,128]", False,
         lambda o: o["exp_gather"].take_rows_kernel(tab128, idx8),
         empty([((128, 128), f32)], lambda: tab128.new_empty((128, 128))),
         lambda: torch.index_select(tab128, 0, idx8[0])),
        ("take_rows", f"[8192,128] f32 by the {L} neighbour ids of synth8191 (main path)", True,
         lambda o: o["exp_gather"].take_rows_kernel(tab_main, ids_main),
         empty([((L, 128), f32)], lambda: tab_main.new_empty((L, 128))),
         lambda: torch.index_select(tab_main, 0, ids_main[0])),
        ("scale_add", "[4096,1280] f32, 48 KB tile", True,
         lambda o: o["mosaic_repros"].scale_add_kernel(x),
         {False: lambda: torch.empty_like(x), True: lambda: torch.empty_like(x)},
         lambda: torch.add(one, x, alpha=2.0)),
        ("rowmax_mul", "[256,128] bf16", False, lambda o: o["mosaic_repros"].rowmax_mul_kernel(xb16),
         {False: lambda: torch.empty_like(xb16), True: lambda: torch.empty_like(xb16)}, None),
        ("carry_and", "[8,128] f32, n=8", False, lambda o: o["mosaic_repros"].carry_and_kernel(xcar, n8),
         empty([((1, 128), f32)], lambda: xcar.new_empty((1, 128))), None),
        ("bitcast_first", "[1,128] f32, rank 1", False,
         lambda o: o["mosaic_repros"].bitcast_first_kernel(x1),
         empty([((1, 128), i32)], lambda: x1.new_empty((1, 128), dtype=i32)), None),
        ("bisect_mask", "[256,512] f32", False, lambda o: o["mosaic_repros"].bisect_mask_kernel(d_small),
         empty([((256, 512), b8)], lambda: torch.empty_like(d_small, dtype=b8)), None),
        ("bisect_mask", "[8192,8192] f32 squared distances of synth8191 (main path)", True,
         lambda o: o["mosaic_repros"].bisect_mask_kernel(dsq_main),
         empty([((8192, 8192), b8)], lambda: torch.empty_like(dsq_main, dtype=b8)), None),
        ("edge_attention", "N=8192 nn=64 fp32", True,
         lambda o: o["edge_attention"].edge_attention_kernel(*edge),
         empty([((8192, 64), f32), ((8192, 192), f32), ((8192, 128), f32)],
               lambda: [edge_qp.new_empty((8192, 64)), edge_qp.new_empty((8192, 192)),
                        edge_qp.new_empty((8192, 128), dtype=f32)]), None),
        # the scratch's size comes from the library; any size costs the host the same
        ("knn", "8191 atoms @ 8192, ids only", True,
         lambda o: o["knn"].knn_kernel(xc, dmax=False)[:2],
         empty([((1, 8, 8), f32), ((1, 8192), i32), ((1,), i32), ((8192 * 64,), f32),
                ((1, 8192, 64), i32), ((1, 8192, 64), b8)],
               lambda: [xc.new_empty((1, 8, 8)), xc.new_empty((1, 8192), dtype=i32),
                        xc.new_empty((1,), dtype=i32), xc.new_empty((8192 * 64,)),
                        xc.new_empty((1, 8192, 64), dtype=i32), xc.new_empty((1, 8192, 64), dtype=b8)]),
         None),
    ]


def measure(fn, n, pieces=None, alloc=None):
    """host_us and the events ms of fn(); with `pieces` (a checkout's
    Stubs) its launch path's parts."""
    from chip_smoke import cuda_time_ms, host_us

    out = {"host_us": host_us(fn, n, REPEATS), "ms": cuda_time_ms(fn, reps=20)}
    if pieces:
        with pieces.c_call():
            no_c = host_us(fn, n, REPEATS)
            with pieces.launch():
                no_launch = host_us(fn, n, REPEATS)
                with pieces.count():
                    rest = host_us(fn, n, REPEATS)
        a = host_us(alloc[pieces.entries], n, REPEATS)
        out["pieces"] = {"c_call": out["host_us"] - no_c, "launch": no_c - no_launch,
                         "count": no_launch - rest, "alloc": a, "checks": rest - a}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--other", help="another checkout of the repository")
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import card_line, device_ms
    from pesto_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    this = load_tree(None)
    trees = {"this": this}
    if args.other:
        trees["other"] = load_tree(args.other)
    for t in trees.values():
        t["_build"].build_all(("exp_gather", "mosaic_repros", "edge_attention", "knn"))
    # the host and events times first, the profiler's device times after
    # them all: a profiled run may leave the launch path slower after it
    # (the primitives are taken before and after)
    order = ["other", "this", "library", "library", "this", "other"]
    prim = primitives([this], dev, args.calls)
    rows, same, cases = [], True, make_cases(dev)
    for case in cases:
        name, label, card_bound, run, alloc, library = case
        fns = {t: (lambda tree=tree, run=run: run(tree)) for t, tree in trees.items()}
        outs = {t: fn() for t, fn in fns.items()}
        torch.cuda.synchronize()
        bits = same_bits(outs["this"], outs["other"]) if args.other else None
        same &= bits is not False
        if library is not None:
            fns["library"] = library
        n = args.calls // 10 if card_bound else args.calls
        turns = {t: [] for t in fns}
        for t in order:
            if t in fns:  # pieces once per checkout, on its first turn
                first = t != "library" and not turns[t]
                turns[t].append(measure(fns[t], n, Stubs(trees[t]["_build"]) if first else None, alloc))
        rows.append({"kernel": name, "shape": label, "bits_equal": bits, "turns": turns, "fns": fns})
        for t, ms in turns.items():
            p = ms[0].get("pieces", {})
            print(f"{name} {label} [{t}]: host us " + ", ".join(f"{m['host_us']:.2f}" for m in ms)
                  + "; events ms " + ", ".join(f"{m['ms']:.4f}" for m in ms)
                  + "".join(f"; pieces us {', '.join(f'{k} {v:.2f}' for k, v in p.items())}" if p else ""),
                  flush=True)
        if args.other:
            print(f"{name} {label}: outputs {'equal' if bits else 'DIFFER'} bit for bit", flush=True)
    for row in rows:
        row["device_ms"] = {t: device_ms(fn)[0] for t, fn in row.pop("fns").items()}
        print(f"{row['kernel']} {row['shape']}: device ms "
              + ", ".join(f"{t} {v:.4f}" for t, v in row["device_ms"].items()), flush=True)
    after = primitives([this], dev, args.calls)
    for k in prim:
        print(f"primitive {k}: " + ", ".join(f"{t:.3f}" for t in prim[k]) + " us; after the profiler "
              + ", ".join(f"{t:.3f}" for t in after[k]) + " us", flush=True)
    line = json.dumps({"device": card_line(), "torch": torch.__version__, "primitives_us": prim,
                       "primitives_after_profiler_us": after, "cases": rows})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
