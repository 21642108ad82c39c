"""Fused edge attention of one state-update layer: the CUDA kernel
`csrc/edge_attention.cu`, its plain version, and the launch counter.

Replaces the TPU kernel `pesto_tpu/ops/geometric_pallas.py`
`fused_edge_attention` (line 257): the whole post-gather StateUpdate chain
(edge features, the packed three-stage ELU edge MLP, the scalar and the
vector softmax, the value sums). The Hopper kernel takes atom-major states
`qp [N, 4S]` and neighbour ids `[N, nn]` and gathers the neighbour rows
itself; the TPU kernel's nn-major input and lane-aligned K2 packing were
shaped for TPU tiles and are not carried over. The kernel runs the three
edge-MLP products on the tensor cores (bf16 operands in bf16 mode, 3xTF32
in fp32 mode) and lays out its weights itself, in shared memory, once per
block. The source note in the .cu file says what bounds the kernel and how
it is laid out.

Weights are the packed tensors of `pesto_tpu/models/pesto.py:233-275`:
K0 [6S+1, 4S] (the three first layers side by side), B0 [4S], K1 [4S, 4S]
block-diagonal, B1 [4S], K2 [4S, Nk + 3Nk + 2S] block-diagonal, B2.
"""

import math

import torch
import torch.nn.functional as F

from . import _build

NN_SUPPORTED = (8, 16, 32, 64)


def safe_norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm floored at sqrt(1e-36), so the zero initial vector state has
    a finite gradient."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=1e-36))


def edge_attention_plain(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3,
                         matmul=torch.matmul):
    """Plain PyTorch version: the packed StateUpdate of the JAX package
    (`StateUpdate._fused`, pesto_tpu/models/pesto.py:202-337) after the
    gather. Returns (Zq [N, Nh*S], Zp [N, 3*Nh*S], x-major then head).

    `matmul` computes the three edge-MLP products (E K0e, h0 K1, h1 K2);
    the tests pass emulations of the kernel's tensor-core arithmetic."""
    N, nn = ids.shape
    q = qp[:, :S]
    p = qp[:, S:].reshape(N, 3, S)
    qp_nn = qp[ids.long()]                                   # [N, nn, 4S]
    q_nn = qp_nn[..., :S]
    p_nn = qp_nn[..., S:].reshape(N, nn, 3, S)
    X_n = torch.cat([q, safe_norm(p, 1)], dim=1)
    proj_p = (p[:, None] * r[..., None]).sum(dim=2)          # [N, nn, S]
    proj_pn = (p_nn * r[..., None]).sum(dim=2)
    E = torch.cat([q_nn, safe_norm(p_nn, 2), proj_p, proj_pn], dim=2)

    per_atom = X_n @ K0[1 : 1 + 2 * S] + B0
    h = matmul(E, K0[1 + 2 * S :]) + d[..., None] * K0[0] + per_atom[:, None, :]
    h = F.elu(h)
    h = F.elu(matmul(h, K1) + B1)
    out = matmul(h, K2) + B2                                 # [N, nn, 76]
    Kq = out[..., :Nk]
    Kp3 = out[..., Nk : 4 * Nk]
    V0 = out[..., 4 * Nk : 4 * Nk + S]
    V1 = out[..., 4 * Nk + S :]

    sdk = math.sqrt(Nk)
    Q = nq.reshape(N, 2, Nh, Nk)
    lq = torch.einsum("nhk,nmk->nhm", Q[:, 0], Kq)
    Mq = torch.softmax(lq / sdk, dim=2)
    lp = torch.cat(
        [torch.einsum("nhk,nmk->nhm", Q[:, 1], Kp3[..., c * Nk : (c + 1) * Nk]) for c in range(3)],
        dim=2,
    )
    Mp = torch.softmax(lp / sdk, dim=2)
    Mp1, Mp2, Mp3 = Mp[..., :nn], Mp[..., nn : 2 * nn], Mp[..., 2 * nn :]

    Zq = torch.einsum("nhm,nms->nhs", Mq, V0).reshape(N, Nh * S)
    Z1 = torch.einsum("nhm,nmx,nms->nxhs", Mp1, r, V1)
    Z2 = torch.einsum("nh,nxs->nxhs", Mp2.sum(dim=2), p)
    Z3 = torch.einsum("nhm,nmxs->nxhs", Mp3, p_nn)
    return Zq, (Z1 + Z2 + Z3).reshape(N, 3 * Nh * S)


def fused_edge_attention(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3):
    """(Zq [N, Nh*S], Zp [N, 3*Nh*S]) of one layer.

    qp [N, 4S] = [q | p flattened x-major]; ids [N, nn] rows of qp (int);
    d [N, nn]; r [N, nn, 3]; nq [N, 2*Nh*Nk] the nqm output. A CPU tensor
    runs the plain version; a CUDA tensor runs the kernel or raises."""
    if qp.is_cuda:
        return edge_attention_kernel(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk)
    if qp.device.type != "cpu":
        raise ValueError(f"fused_edge_attention: unsupported device {qp.device}")
    return edge_attention_plain(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def edge_attention_kernel(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3):
    """Launch csrc/edge_attention.cu (S=32, Nh=2, Nk=3; nn in 8/16/32/64).
    One launch, counted once, runs its two kernels: the per-atom pre-pass
    and the tile kernel."""
    if not qp.is_cuda:
        raise ValueError("edge_attention_kernel: needs CUDA tensors")
    if (S, Nh, Nk) != (32, 2, 3):
        raise ValueError(f"edge kernel is built for S=32, Nh=2, Nk=3, got {(S, Nh, Nk)}")
    N, nn = ids.shape
    if nn not in NN_SUPPORTED:
        raise ValueError(f"edge kernel takes nn in {NN_SUPPORTED}, got {nn}")
    dt = qp.dtype
    if dt not in _DTYPES:
        raise ValueError(f"edge kernel takes float32 or bfloat16, got {dt}")
    shapes = {
        "qp": (qp, (N, 4 * S)), "d": (d, (N, nn)), "r": (r, (N, nn, 3)),
        "nq": (nq, (N, 2 * Nh * Nk)), "K0": (K0, (6 * S + 1, 4 * S)), "B0": (B0, (4 * S,)),
        "K1": (K1, (4 * S, 4 * S)), "B1": (B1, (4 * S,)),
        "K2": (K2, (4 * S, 4 * Nk + 2 * S)), "B2": (B2, (4 * Nk + 2 * S,)),
    }
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dt or x.device != qp.device or not x.is_contiguous():
            raise ValueError(
                f"edge kernel: {name} must be a contiguous {dt} tensor of shape {shape} "
                f"on {qp.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if ids.dtype != torch.int32 or ids.device != qp.device or not ids.is_contiguous():
        raise ValueError("edge kernel: ids must be a contiguous int32 tensor on the same device")
    if qp.data_ptr() % 16:
        raise ValueError("edge kernel: qp must be 16-byte aligned (its rows are copied 16 B at a time)")
    zq = torch.empty((N, Nh * S), dtype=dt, device=qp.device)
    zp = torch.empty((N, 3 * Nh * S), dtype=dt, device=qp.device)
    per_atom = torch.empty((N, 4 * S), dtype=torch.float32, device=qp.device)  # scratch
    _build.call("edge_attention", "edge_attention", qp.device, _DTYPES[dt],
                qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, per_atom, N, nn)
    edge_attention_kernel.launches += 1
    return zq, zp


edge_attention_kernel.launches = 0
