"""Exact 64-NN selection: the CUDA kernel `csrc/knn.cu`, its plain version,
and the launch counter.

Replaces the TPU kernel `pesto_tpu/ops/knn_pallas.py` (`knn_candidates`,
line 177, then `knn_select`, line 256). That kernel builds a candidate
superset from a Morton band, a bisection and a compaction shaped for TPU
lanes, and falls back to the exact XLA path on overflow or when n <= k.
The port owes only the output contract of the exact path
(`pesto_tpu/topology.py` `_knn_core`): for every row of a padded structure
with sink row 0,

  - Gram-form squared distances sq_i + sq_j - 2 x_i.x_j on coordinates
    centred on the valid atoms, clamped at 0;
  - self (row == col) and Dsq < 1e-4 pushed by +4e9, invalid pairs 1e10;
  - the lexicographic (value, id) top-64, so ties go to the lower id;
  - ok = value < 5e9, and the id of a slot that is not ok is 0;
  - Dmax = sqrt(max Dsq over valid pairs), one per structure.

With n <= k the pushed self/duplicate candidates stay ok, as in the exact
path. The kernel is exact, so there is no overflow and no fallback.

On a CUDA tensor one call launches: the Morton keys of each structure
(`knn_prep`), a stable `torch.sort` of the keys, the sorted atoms with
per-tile bounding boxes and the scan that selects (`knn_top64`), and, only
where Dmax is asked for, a dense max over the valid pairs (`knn_dmax`).
The scan takes each row's threshold from the 7 tiles of 32 sorted atoms
around it, skips tiles by bounding box and compacts the candidates under
the threshold into a buffer of SLOTS keys per row (csrc/knn.cu has the
design). The constants below are the kernel's schedule, as csrc/knn.cu
declares it (tests/test_torch_knn_schedule.py holds them equal).
"""

import torch

from . import _build

K = 64
PUSH = 4e9
BIG = 1e10
BIGHALF = 5e9
# the kernel's schedule (csrc/knn.cu): atoms per block of the Morton pass,
# sorted atoms per tile, tiles per group, the window (the row's tile and
# WINDOW tiles each side), candidate slots per row, and the prune margin
# MARGIN_REL * (w_row + w_tile) + MARGIN_ABS on top of the threshold
PREP = 1024
TILE = 32
GROUP = 32 * TILE
WINDOW = 3
SLOTS = 128
MARGIN_REL = 2e-6
MARGIN_ABS = 1e-6
INVALID_KEY = 1 << 30


def center_coords(Xp: torch.Tensor, atom_mask: torch.Tensor) -> torch.Tensor:
    """[B, NA, 3] coordinates -> [B, NA, 4] (x, y, z, w): coordinates
    centred on each structure's valid atoms, with w = |x|^2 for a valid
    atom and -1 for the sink and padding rows (which are zeroed)."""
    m = (atom_mask > 0).to(torch.float32)
    n_valid = m.sum(dim=1).clamp_min(1.0)
    center = (Xp * m[..., None]).sum(dim=1) / n_valid[:, None]
    xc = (Xp - center[:, None, :]) * m[..., None]
    sq = (xc * xc).sum(dim=-1)
    w = torch.where(m > 0, sq, torch.full_like(sq, -1.0))
    return torch.cat([xc, w[..., None]], dim=-1).contiguous()


def knn_plain(xc4: torch.Tensor, k: int = K, row_block: int = None):
    """Plain PyTorch version of the kernel on centred [B, NA, 4] input.

    Row-blocked like `pesto_tpu/topology.py` so that a large bucket never
    holds an NA x NA matrix. The selection is a stable sort, which keeps
    ascending column order among equal values: the lexicographic (value,
    id) order that `lax.top_k` gives. Returns (ids [B,NA,k] int32,
    ok [B,NA,k] bool, Dmax [B] float32)."""
    B, NA, _ = xc4.shape
    if row_block is None:
        row_block = min(NA, max(512, ((256 << 20) // (4 * NA)) // 512 * 512))
    dev = xc4.device
    ids = torch.zeros((B, NA, k), dtype=torch.int32, device=dev)
    ok = torch.zeros((B, NA, k), dtype=torch.bool, device=dev)
    dsq_max = torch.zeros((B,), dtype=torch.float32, device=dev)
    cols = torch.arange(NA, device=dev)
    kk = min(k, NA)
    for b in range(B):
        xyz, w = xc4[b, :, :3], xc4[b, :, 3]
        valid = w >= 0
        sq = w.clamp_min(0.0)
        for r0 in range(0, NA, row_block):
            r1 = min(NA, r0 + row_block)
            G = xyz[r0:r1] @ xyz.T
            dsq = (sq[r0:r1, None] + sq[None, :] - 2.0 * G).clamp_min(0.0)
            pair = valid[r0:r1, None] & valid[None, :]
            if pair.any():
                dsq_max[b] = torch.maximum(dsq_max[b], dsq[pair].max())
            dup = (cols[r0:r1, None] == cols[None, :]) | (dsq < 1e-4)
            v = dsq + PUSH * dup.to(dsq.dtype)
            v = torch.where(pair, v, torch.full_like(v, BIG))
            sv, si = torch.sort(v, dim=1, stable=True)
            sv, si = sv[:, :kk], si[:, :kk]
            good = sv < BIGHALF
            ids[b, r0:r1, :kk] = torch.where(good, si, 0).to(torch.int32)
            ok[b, r0:r1, :kk] = good
    return ids, ok, dsq_max.sqrt()


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the 10 low bits."""
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_keys_plain(xc4: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's Morton keys: [B, NA, 4] -> [B, NA]
    int32, the 30-bit Z-order code of each valid atom over its structure's
    bounding box, 10 bits per axis in float64 (the logic of
    `pesto_tpu/spatial.py` `morton_order`); the sink and padding get 2^30,
    so a stable sort puts them last."""
    X = xc4[..., :3].double()
    valid = xc4[..., 3] >= 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=xc4.device)
    lo = torch.where(valid[..., None], X, inf).amin(dim=1, keepdim=True)
    hi = torch.where(valid[..., None], X, -inf).amax(dim=1, keepdim=True)
    span = (hi - lo).clamp_min(1e-9)
    q = torch.where(valid[..., None], (X - lo) / span * 1024, torch.zeros_like(X))
    q = q.to(torch.int64).clamp_max(1023)
    code = _spread10(q[..., 0]) | (_spread10(q[..., 1]) << 1) | (_spread10(q[..., 2]) << 2)
    return torch.where(valid, code, INVALID_KEY).to(torch.int32)


def morton_keys(xc4: torch.Tensor):
    """(keys [B, NA] int32, valid atoms [B] int32): the plain version on a
    CPU tensor, the kernel `knn_prep` on a CUDA tensor."""
    if not _build.on_cuda(xc4, "morton_keys"):
        return morton_keys_plain(xc4), (xc4[..., 3] >= 0).sum(dim=1).to(torch.int32)
    _check_xc4(xc4, "morton_keys")
    B, NA, _ = xc4.shape
    part = torch.empty((B, -(-NA // PREP), 8), dtype=torch.float32, device=xc4.device)
    keys = torch.empty((B, NA), dtype=torch.int32, device=xc4.device)
    nvalid = torch.empty((B,), dtype=torch.int32, device=xc4.device)
    _build.call("knn", "knn_prep", xc4.device, xc4, B, NA, part, keys, nvalid)
    return keys, nvalid


def knn_topk(Xp: torch.Tensor, atom_mask: torch.Tensor, k: int = K):
    """Exact top-k neighbour ids of every row of a padded batch.

    Xp [B, NA, 3] float32, atom_mask [B, NA] -> (ids [B,NA,k] int32,
    ok [B,NA,k] bool, Dmax [B] float32). A CPU tensor runs the plain
    version; a CUDA tensor runs the kernel (k <= 64) or raises."""
    xc4 = center_coords(Xp.to(torch.float32), atom_mask)
    if not _build.on_cuda(Xp, "knn_topk"):
        return knn_plain(xc4, k)
    _check_k(k)
    ids, ok, dmax = knn_kernel(xc4)
    return ids[..., :k], ok[..., :k], dmax


def knn_ids(Xp: torch.Tensor, atom_mask: torch.Tensor, k: int = K):
    """`knn_topk` without Dmax: (ids [B,NA,k] int32, ok [B,NA,k] bool).
    On a CUDA tensor the kernel runs no Dmax pass."""
    xc4 = center_coords(Xp.to(torch.float32), atom_mask)
    if not _build.on_cuda(Xp, "knn_ids"):
        return knn_plain(xc4, k)[:2]
    _check_k(k)
    ids, ok, _ = knn_kernel(xc4, dmax=False)
    return ids[..., :k], ok[..., :k]


def _check_k(k):
    if k > K:
        raise ValueError(f"the kNN kernel selects at most {K} neighbours, got k={k}")


def _check_xc4(xc4, what):
    if not (xc4.is_cuda and xc4.dtype == torch.float32 and xc4.dim() == 3
            and xc4.shape[-1] == 4 and xc4.is_contiguous()):
        raise ValueError(f"{what}: needs a contiguous [B, NA, 4] float32 CUDA tensor")


def knn_kernel(xc4: torch.Tensor, dmax: bool = True, stats: torch.Tensor = None):
    """Launch csrc/knn.cu on centred [B, NA, 4] float32 CUDA input.

    Returns (ids, ok, Dmax), Dmax None when dmax is False. stats, if given,
    is a zeroed [4] int64 CUDA tensor that receives the pairs evaluated,
    the largest fill of a row's candidate buffer, the rows whose buffer
    was cut, and the cuts."""
    _check_xc4(xc4, "knn_kernel")
    if stats is not None:
        _build.need_cuda(stats, (torch.int64,), 1, "knn_kernel stats")
        if stats.numel() < 4:
            raise ValueError("knn_kernel: stats needs 4 entries")
    B, NA, _ = xc4.shape
    dev = xc4.device
    keys, nvalid = morton_keys(xc4)
    perm = torch.sort(keys, dim=1, stable=True).indices
    words = _build.host_call("knn", "knn_scratch_floats", B, NA)
    scratch = torch.empty((words,), dtype=torch.float32, device=dev)
    ids = torch.empty((B, NA, K), dtype=torch.int32, device=dev)
    ok = torch.empty((B, NA, K), dtype=torch.bool, device=dev)
    if stats is None:
        _build.call("knn", "knn_top64", dev, xc4, perm, B, NA, scratch, nvalid, ids, ok)
    else:
        _build.call("knn", "knn_top64_stats", dev, xc4, perm, B, NA, scratch, nvalid, ids, ok,
                    stats)
    d = None
    if dmax:
        bits = torch.zeros((B,), dtype=torch.int32, device=dev)
        _build.call("knn", "knn_dmax", dev, xc4, B, NA, bits)
        d = bits.view(torch.float32).sqrt()
    knn_kernel.launches += 1
    return ids, ok, d


knn_kernel.launches = 0
