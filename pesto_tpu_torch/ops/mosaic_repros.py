"""The kernels of the five Mosaic repro cases: the CUDA kernels of
`csrc/mosaic_repros.cu`, their plain versions, and the launch counters.

Each replaces one TPU kernel of `docs/mosaic_repros.py`:

  scale_add      case_vmem500.kernel (line 56): 2x + 1 through a scratch tile
  rowmax_mul     case_bf16broadcast.kernel (line 87): x * rowmax(x), fp32/bf16
  carry_and      case_i1carry.kernel (line 109): an AND carried over n rows
  bitcast_first  case_bitcast0.kernel (line 147): the bits of x[0, 0]
  bisect_mask    case_bisecthang.kernel (line 178): per-row bisection mask

All five compute exact functions, so each kernel equals its plain version
bit for bit (`same_bits`). Every public function runs the plain version for
a CPU tensor and launches the kernel, or raises, for a CUDA tensor.

`bisect_mask_plain` is the TPU kernel's loop: 16 steps, each counting the
row's values at or under the pivot. The CUDA kernel computes the same mask
another way: a step's test count(d <= mid) < 64 is exactly v64 > mid, with
v64 the row's 64th smallest non-NaN value (+inf when there are fewer), so
it finds v64 once per row (a rank count among the few values under a bound
taken from the threads' minima, or a radix select over the floats' order-
preserving keys when many values tie there), replays the 16 steps on it as
scalar code and writes hi >= d. It reads each row from memory once and is
bound by bytes.
"""

import torch

from . import _build

# a block's shared memory without opting in, and Hopper's opt-in maximum
SHARED_DEFAULT = 48 * 1024
SHARED_RAISED = 227 * 1024
BISECT_HI = 1e6
BISECT_STEPS = 16
BISECT_K = 64

_INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
_F32 = (torch.float32,)
_SCALE_ADD = _build.Entry("mosaic_repros", "scale_add", "ppii")
_ROWMAX_MUL = _build.Entry("mosaic_repros", "rowmax_mul", "ippii")
_CARRY_AND = _build.Entry("mosaic_repros", "carry_and", "ipppii")
_BITCAST_FIRST = _build.Entry("mosaic_repros", "bitcast_first", "ippi")
_BISECT_MASK = _build.Entry("mosaic_repros", "bisect_mask", "ppii")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bits, except that any NaN equals any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = _INT_OF[a.dtype]
    return torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


# ---------------------------------------------------------------- scale_add


def scale_add_plain(x: torch.Tensor) -> torch.Tensor:
    scratch = x * 2.0
    return scratch + 1.0


def scale_add_kernel(x: torch.Tensor, raised: bool = False) -> torch.Tensor:
    """2x + 1 streamed through a shared-memory tile of SHARED_DEFAULT bytes
    per block, or of SHARED_RAISED (opted in) when `raised`."""
    _build.need_cuda(x, _F32, x.dim(), "scale_add_kernel")
    n = x.numel()
    if n % 4 or x.data_ptr() % 16:
        raise ValueError("scale_add_kernel: needs a 16-byte aligned tensor of 4k elements")
    out = torch.empty_like(x)
    _SCALE_ADD(x, out, n, SHARED_RAISED if raised else SHARED_DEFAULT)
    _build.count_launch(scale_add_kernel)
    return out


def scale_add(x: torch.Tensor, raised: bool = False) -> torch.Tensor:
    if _build.on_cuda(x, "scale_add"):
        return scale_add_kernel(x, raised)
    return scale_add_plain(x)


# ---------------------------------------------------------------- rowmax_mul


def rowmax_mul_plain(x: torch.Tensor) -> torch.Tensor:
    return x * x.amax(dim=1, keepdim=True)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rowmax_mul_kernel(x: torch.Tensor) -> torch.Tensor:
    """x * max(x, axis=1) on [rows, cols] fp32 or bf16; a NaN in a row
    makes the row NaN."""
    _build.need_cuda(x, tuple(_DTYPES), 2, "rowmax_mul_kernel")
    out = torch.empty_like(x)
    _ROWMAX_MUL(_DTYPES[x.dtype], x, out, *x.shape)
    _build.count_launch(rowmax_mul_kernel)
    return out


def rowmax_mul(x: torch.Tensor) -> torch.Tensor:
    if _build.on_cuda(x, "rowmax_mul"):
        return rowmax_mul_kernel(x)
    return rowmax_mul_plain(x)


# ---------------------------------------------------------------- carry_and


def carry_and_plain(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rows i < n of x (n a one-element int32 tensor, read without leaving
    the device) all > 0.5, and row 0 > 0: [1, cols] float32 of 0 and 1."""
    live = torch.arange(x.shape[0], device=x.device)[:, None] < n.reshape(1, 1)
    keep = ((x > 0.5) | ~live).all(dim=0)
    return ((x[0] > 0) & keep).to(torch.float32)[None]


def carry_and_kernel(x: torch.Tensor, n: torch.Tensor, as_bool: bool = False) -> torch.Tensor:
    """The per-column carry as an int32 or (as_bool) a bool."""
    _build.need_cuda(x, _F32, 2, "carry_and_kernel")
    _build.need_cuda(n, (torch.int32,), 1, "carry_and_kernel")
    if n.get_device() != x.get_device() or n.numel() != 1 or x.shape[0] == 0:
        raise ValueError("carry_and_kernel: needs x with rows and a one-element n beside it")
    out = x.new_empty((1, x.shape[1]))
    _CARRY_AND(int(as_bool), x, n, out, *x.shape)
    _build.count_launch(carry_and_kernel)
    return out


def carry_and(x: torch.Tensor, n: torch.Tensor, as_bool: bool = False) -> torch.Tensor:
    if _build.on_cuda(x, "carry_and"):
        return carry_and_kernel(x, n, as_bool)
    return carry_and_plain(x, n)


# ---------------------------------------------------------------- bitcast_first


def bitcast_first_plain(x: torch.Tensor) -> torch.Tensor:
    return x[0, :1].view(torch.int32).expand(1, x.shape[1]).contiguous()


def bitcast_first_kernel(x: torch.Tensor, rank: int = 1) -> torch.Tensor:
    """The int32 bits of x[0, 0] across a [1, cols] row, read as a rank-0
    scalar or (rank 1) a one-element vector."""
    _build.need_cuda(x, _F32, 2, "bitcast_first_kernel")
    if rank not in (0, 1) or x.numel() == 0:
        raise ValueError("bitcast_first_kernel: needs a non-empty x and rank 0 or 1")
    out = x.new_empty((1, x.shape[1]), dtype=torch.int32)
    _BITCAST_FIRST(rank, x, out, x.shape[1])
    _build.count_launch(bitcast_first_kernel)
    return out


def bitcast_first(x: torch.Tensor, rank: int = 1) -> torch.Tensor:
    if _build.on_cuda(x, "bitcast_first"):
        return bitcast_first_kernel(x, rank)
    return bitcast_first_plain(x)


# ---------------------------------------------------------------- bisect_mask


def bisect_mask_plain(d: torch.Tensor) -> torch.Tensor:
    """Per row, BISECT_STEPS bisection steps on [0, BISECT_HI]: the pivot
    moves up while fewer than BISECT_K values are <= it; then hi >= d."""
    lo = torch.zeros((d.shape[0], 1), dtype=torch.float32, device=d.device)
    hi = torch.full_like(lo, BISECT_HI)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        up = (d <= mid).sum(dim=1, keepdim=True) < BISECT_K
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return hi >= d


def bisect_mask_kernel(d: torch.Tensor) -> torch.Tensor:
    """[rows, cols] float32 -> bool, equal to `bisect_mask_plain`; a row
    must fit in SHARED_RAISED bytes."""
    _build.need_cuda(d, _F32, 2, "bisect_mask_kernel")
    if 4 * d.shape[1] > SHARED_RAISED:
        raise ValueError(f"bisect_mask_kernel: rows of {d.shape[1]} do not fit in shared memory")
    out = torch.empty_like(d, dtype=torch.bool)
    _BISECT_MASK(d, out, *d.shape)
    _build.count_launch(bisect_mask_kernel)
    return out


def bisect_mask(d: torch.Tensor) -> torch.Tensor:
    if _build.on_cuda(d, "bisect_mask"):
        return bisect_mask_kernel(d)
    return bisect_mask_plain(d)


KERNELS = (scale_add_kernel, rowmax_mul_kernel, carry_and_kernel, bitcast_first_kernel,
           bisect_mask_kernel)
for _k in KERNELS:
    _k.launches = 0
