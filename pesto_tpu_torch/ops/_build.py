"""Build the CUDA sources in ../csrc into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so`, where the
hash covers the source and the flags, so an edited source is rebuilt. The
library is loaded with ctypes, and each of its C entry points is called
through an `Entry` that the kernel's module creates at import. Nothing
here builds or loads at import time; `nvcc` exists only where there is a
GPU.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ..utils import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("knn", "edge_attention", "edge_attention_bwd", "cross_attention", "mosaic_repros", "exp_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.RLock()  # builds, loads and binds
_count_lock = threading.Lock()
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


def cuda_calls():
    """(current device, raw current stream of a device): torch's own calls,
    which exist only in a CUDA build of torch. The second gives a device's
    current stream as an int without building a `torch.cuda.Stream`; the
    wrapper code that `torch.compile` generates uses it too."""
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


class Entry:
    """One C entry point of csrc/<source>.cu, bound at its first call: the
    port's one way to call its kernels.

    `kinds` spells its arguments in order, "p" for a pointer (pass a
    tensor: its data_ptr() goes, as a full 64-bit value) and "i" for a C
    int. A launcher (the default) returns a cudaError_t and takes, after
    them, the current stream of the first tensor's device; the call enters
    that device only when it is not the current one, and raises
    RuntimeError naming the entry on a non-zero status. A host function
    (`host=True`) takes ints only, launches nothing and returns its 64-bit
    result (a buffer size, say). Creating an entry builds and loads
    nothing; the first call builds and loads its library (`load`) and sets
    the C function's argument types once. While spans are recorded
    (`utils.tracing`), a launch stamps its name and host time just before
    the C call."""

    bound = []  # the entries bound so far in this process

    __slots__ = ("source", "name", "kinds", "host", "_n", "_ptr", "_first", "_fn", "_error",
                 "_device", "_stream")

    def __init__(self, source: str, name: str, kinds: str, host: bool = False):
        if not set(kinds) <= {"p", "i"} or ("p" in kinds) == host:
            raise ValueError(f"{name}: kinds {kinds!r} must be 'p' and 'i', with a pointer "
                             "exactly when it launches")
        self.source, self.name, self.kinds, self.host = source, name, kinds, host
        self._n = len(kinds)
        self._ptr = tuple(k == "p" for k in kinds)
        self._first = kinds.find("p")
        self._fn = None

    def _bind(self):
        with _lock:
            if self._fn is not None:
                return self._fn
            lib = load(self.source)
            fn = lib[self.name]
            if self.host:
                fn.argtypes = [ctypes.c_int] * self._n
                fn.restype = ctypes.c_longlong
            else:
                fn.argtypes = [*(ctypes.c_void_p if p else ctypes.c_int for p in self._ptr),
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._error = lib["error_string"]
                self._error.argtypes, self._error.restype = [ctypes.c_int], ctypes.c_char_p
                self._device, self._stream = cuda_calls()
            self._fn = fn
            Entry.bound.append(self)
            return fn

    def __call__(self, *args):
        fn = self._fn or self._bind()
        if len(args) != self._n:
            raise TypeError(f"{self.name} takes {self._n} arguments ({self.kinds}), got {len(args)}")
        if self.host:
            return fn(*args)
        vals = [a.data_ptr() if p else a for p, a in zip(self._ptr, args)]
        dev = args[self._first].get_device()
        tracing.launch(self.name)
        if dev == self._device():
            status = fn(*vals, self._stream(dev))
        else:
            with torch.cuda.device(dev):
                status = fn(*vals, self._stream(dev))
        if status:
            raise RuntimeError(f"{self.name} launch: CUDA error {status} "
                               f"({self._error(status).decode()})")


def count_launch(kernel) -> None:
    """Add one to `kernel.launches`. `+=` on an attribute is not atomic, and
    the serving path launches from several threads."""
    with _count_lock:
        kernel.launches += 1


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
