"""Build the CUDA sources in ../csrc into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so`, where the
hash covers the source and the flags, so an edited source is rebuilt. The
library is loaded with ctypes. Nothing here runs at import time; `nvcc`
exists only where there is a GPU.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("knn", "edge_attention", "mosaic_repros", "exp_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
# ptxas's register / shared-memory / spill report of each build
build_logs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{h}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (target, Popen or None)."""
    out = _target(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return out, proc


def _finish(name: str, out: str, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(proc.tmp, out)


def build_all(names=SOURCES) -> float:
    """Build every source at once (one nvcc process each, all started
    together) and load them. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names if n not in _libs]
        for n, out, proc in started:
            _finish(n, out, proc)
            _libs[n] = ctypes.CDLL(out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


# (source, entry, argument kinds) -> (library, C function with its argtypes set)
_entries: dict = {}


def _entry(source: str, entry: str, args) -> tuple:
    kinds = tuple(isinstance(a, torch.Tensor) for a in args)
    key = (source, entry, kinds)
    found = _entries.get(key)
    if found is None:
        lib = load(source)
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p if k else ctypes.c_int for k in kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        found = _entries[key] = (lib, fn)
    return found


def call(source: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` of csrc/<source>.cu on the current
    stream of `device`: a tensor passes as its data pointer, an int as a C
    int, and the stream comes last. The argument types are set once per
    entry point; the device is entered only when it is not the current one.
    Raises on a non-zero status."""
    lib, fn = _entry(source, entry, args)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if device.index is None or device.index == torch.cuda.current_device():
        status = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            status = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    check(lib, status, f"{entry} launch")


def host_call(source: str, entry: str, *ints) -> int:
    """The 64-bit result of the host function `entry` of csrc/<source>.cu,
    which takes C ints and launches nothing (a buffer size, say)."""
    key = (source, entry, "host")
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(source), entry)
        fn.argtypes = [ctypes.c_int] * len(ints)
        fn.restype = ctypes.c_longlong
        _entries[key] = fn
    return fn(*ints)


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def need_cuda(x: torch.Tensor, dtypes, dim: int, what: str) -> None:
    """Raise unless x is a contiguous CUDA tensor of `dim` dimensions and
    one of `dtypes`."""
    if not (x.is_cuda and x.dtype in dtypes and x.dim() == dim and x.is_contiguous()):
        raise ValueError(f"{what}: needs a contiguous {dim}-d CUDA tensor of {dtypes}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
