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
on warpgroup MMA in fp32 mode) and lays out its weights itself: bf16 in
shared memory once per block, fp32 split into TF32 hi and lo once per
launch, into scratch after the per-atom terms. The source note in the .cu
file says what bounds the kernel and how it is laid out.

Weights are the packed tensors of `pesto_tpu/models/pesto.py:233-275`:
K0 [6S+1, 4S] (the three first layers side by side), B0 [4S], K1 [4S, 4S]
block-diagonal, B1 [4S], K2 [4S, Nk + 3Nk + 2S] block-diagonal, B2.

The kernel writes into fresh buffers, so its outputs carry no autograd
history. While autograd records, `fused_edge_attention` runs it through
`EdgeAttentionFunction`, which keeps only the per-atom inputs; on the card
its backward launches the backward kernel `csrc/edge_attention_bwd.cu`
(`edge_attention_backward_kernel`), which rebuilds the edge activations
tile by tile, as the JAX package's per-layer remat
(`remat_policy="full"`) rebuilds them, and returns the layer's VJP. The
TPU kernel has no backward (it is inference-only,
pesto_tpu/models/config.py:76-80): the JAX package differentiates XLA
ops, and `edge_attention_backward_plain` writes that VJP out in plain
PyTorch, step by step in the kernel's order. On CPU tensors the backward
reruns `edge_attention_plain` under autograd.

Under `torch.export` the layer is the registered operator
`pesto_tpu_torch::edge_attention` (`edge_attention_op`, torch.library):
its CPU implementation is the plain version, its CUDA implementation the
launcher, and its fake implementation gives `torch.export` the output
shapes, so an exported program (`Predictor.export_compiled`) holds one
node of it per layer. Importing this module registers it. Eager calls go
to the plain version or the launcher directly.
"""

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

NN_SUPPORTED = (8, 16, 32, 64)


def safe_norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm floored at sqrt(1e-36), so the zero initial vector state has
    a finite gradient."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=1e-36))


def edge_attention_plain(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3,
                         row0=0, matmul=torch.matmul):
    """Plain PyTorch version: the packed StateUpdate of the JAX package
    (`StateUpdate._fused`, pesto_tpu/models/pesto.py:202-337) after the
    gather. Returns (Zq [N, Nh*S], Zp [N, 3*Nh*S], x-major then head) of
    the N = len(ids) atoms whose own rows are qp[row0 : row0 + N]; ids may
    name any row of qp.

    `matmul` computes the three edge-MLP products (E K0e, h0 K1, h1 K2);
    the tests pass emulations of the kernel's tensor-core arithmetic."""
    N, nn = ids.shape
    q = qp[row0 : row0 + N, :S]
    p = qp[row0 : row0 + N, S:].reshape(N, 3, S)
    # index_select, whose backward adds with atomics: advanced indexing's
    # sorts its indices and adds the rows of one index in turn, which is
    # slow when every padding row gathers the sink row 0 (PERF.md)
    qp_nn = torch.index_select(qp, 0, ids.reshape(-1)).reshape(N, nn, 4 * S)
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


def _elu_grad(h):
    """elu'(x) from y = elu(x): 1 where x > 0 (y > 0), else exp(x) = y + 1."""
    return torch.where(h > 0, torch.ones_like(h), h + 1)


def _norm_grad(g, sq, nrm):
    """d|v|/dv's factor g / |v| of safe_norm, zero where clamp's floor holds
    (sum of squares below 1e-36: clamp's gradient is 0 there)."""
    return torch.where(sq >= 1e-36, g / nrm, torch.zeros_like(g))


GRAD_NAMES = ("qp", "d", "r", "nq", "K0", "B0", "K1", "B1", "K2", "B2")


def block_masks(K1, K2, S=32, Nk=3):
    """(K1 mask, K2 mask): ones on the diagonal blocks that `_pack`'s
    block_diag fills (q | p | v), zeros elsewhere."""
    m1 = torch.block_diag(*[torch.ones(n, n) for n in (S, S, 2 * S)])
    m2 = torch.block_diag(torch.ones(S, Nk), torch.ones(S, 3 * Nk), torch.ones(2 * S, 2 * S))
    return m1.to(K1), m2.to(K2)


def edge_attention_backward_plain(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, grad_zq, grad_zp,
                                  S=32, Nh=2, Nk=3, row0=0, need=(True,) * 10,
                                  matmul=torch.matmul, rnd=lambda x: x):
    """The VJP of `edge_attention_plain` written out in plain PyTorch, with
    no autograd, step by step in the order of csrc/edge_attention_bwd.cu.

    Returns the gradients of (qp, d, r, nq, K0, B0, K1, B1, K2, B2), None
    where `need` (those ten flags) says no. qp's covers the whole table;
    K1's and K2's are zero off the diagonal blocks (only those reach the
    parameters through `_pack`'s block_diag). Atoms whose gradient rows
    are all zero reach no loss and are skipped, as the kernel skips them:
    with finite inputs every term of theirs is an exact zero. `matmul`
    computes every product of the edge MLP, forward and backward, and
    `rnd` is applied to h0, h1, `out` and dE, the values that the kernel
    keeps in its working type and reads outside a product too (elu' reads
    h0 and h1, the edge features dE); the tests pass emulations of the
    kernel's bf16 arithmetic."""
    N, nn = ids.shape
    act = torch.nonzero((grad_zq != 0).any(1) | (grad_zp != 0).any(1)).squeeze(1)
    n = act.shape[0]
    sdk = math.sqrt(Nk)
    K0e, k0d, K0x = K0[1 + 2 * S :], K0[0], K0[1 : 1 + 2 * S]

    # ---- the forward, rebuilt for the active atoms
    own = qp[row0 + act]
    q, p = own[:, :S], own[:, S:].reshape(n, 3, S)
    m = ids[act].long()
    nb = qp[m.reshape(-1)].reshape(n, nn, 4 * S)
    p_m = nb[..., S:].reshape(n, nn, 3, S)
    d_a, r_a, nq_a = d[act], r[act], nq[act]
    sq_m, sq_n = (p_m * p_m).sum(2), (p * p).sum(1)
    nrm_m, nrm_n = torch.sqrt(torch.clamp(sq_m, min=1e-36)), torch.sqrt(torch.clamp(sq_n, min=1e-36))
    E = torch.cat([nb[..., :S], nrm_m, (p[:, None] * r_a[..., None]).sum(2), (p_m * r_a[..., None]).sum(2)], 2)
    X_n = torch.cat([q, nrm_n], 1)
    h0 = rnd(F.elu(matmul(E, K0e) + d_a[..., None] * k0d + (X_n @ K0x + B0)[:, None]))
    h1 = rnd(F.elu(matmul(h0, K1) + B1))
    out = rnd(matmul(h1, K2) + B2)
    Kq, Kp3, V0, V1 = out[..., :Nk], out[..., Nk : 4 * Nk], out[..., 4 * Nk : 4 * Nk + S], out[..., 4 * Nk + S :]
    Q = nq_a.reshape(n, 2, Nh, Nk)
    Mq = torch.softmax(torch.einsum("nhk,nmk->nhm", Q[:, 0], Kq) / sdk, dim=2)
    lp = torch.stack([torch.einsum("nhk,nmk->nhm", Q[:, 1], Kp3[..., c * Nk : (c + 1) * Nk])
                      for c in range(3)], 2)                             # [n, Nh, 3, nn]
    Mp = torch.softmax(lp.reshape(n, Nh, 3 * nn) / sdk, dim=2).reshape(n, Nh, 3, nn)

    # ---- the value sums: Zq = Mq V0, Zp = Mp1 r V1 + (sum Mp2) p_n + Mp3 p_m
    gq = grad_zq[act].reshape(n, Nh, S)
    gp = grad_zp[act].reshape(n, 3, Nh, S)
    dMq = torch.einsum("nhs,nms->nhm", gq, V0)
    T = torch.einsum("nxhs,nms->nhmx", gp, V1)                           # [n, Nh, nn, 3]
    dMp = torch.stack([(T * r_a[:, None]).sum(3),
                       torch.einsum("nxhs,nxs->nh", gp, p)[..., None].expand(n, Nh, nn),
                       torch.einsum("nxhs,nmxs->nhm", gp, p_m)], 2)     # [n, Nh, 3, nn]
    dr = (Mp[:, :, 0, :, None] * T).sum(1)                              # Z1's part
    dV0 = torch.einsum("nhm,nhs->nms", Mq, gq)
    dV1 = torch.einsum("nhm,nmx,nxhs->nms", Mp[:, :, 0], r_a, gp)

    # ---- the two softmaxes
    dlq = Mq * (dMq - (Mq * dMq).sum(2, keepdim=True)) / sdk
    dlp = Mp * (dMp - (Mp * dMp).sum((2, 3), keepdim=True)) / sdk
    dnq = torch.stack([torch.einsum("nhm,nmk->nhk", dlq, Kq),
                       sum(torch.einsum("nhm,nmk->nhk", dlp[:, :, c], Kp3[..., c * Nk : (c + 1) * Nk])
                           for c in range(3))], 1).reshape(n, 2 * Nh * Nk)
    dKp3 = torch.cat([torch.einsum("nhm,nhk->nmk", dlp[:, :, c], Q[:, 1]) for c in range(3)], 2)
    dout = torch.cat([torch.einsum("nhm,nhk->nmk", dlq, Q[:, 0]), dKp3, dV0, dV1], 2)  # [n, nn, 76]

    # ---- the edge MLP, transposed (dX) and against its inputs (dW)
    m1, m2 = block_masks(K1, K2, S, Nk)
    flat = lambda x: x.reshape(n * nn, x.shape[-1])  # noqa: E731
    dK2 = matmul(flat(h1).T, flat(dout)) * m2
    dpre1 = matmul(dout, K2.T) * _elu_grad(h1)
    dK1 = matmul(flat(h0).T, flat(dpre1)) * m1
    dpre0 = matmul(dpre1, K1.T) * _elu_grad(h0)
    dK0e = matmul(flat(E).T, flat(dpre0))
    dE = rnd(matmul(dpre0, K0e.T))
    dpa = dpre0.sum(1)                                                   # [n, 4S]
    dX = dpa @ K0x.T                                                     # [n, 2S]
    dK0 = torch.cat([(d_a[..., None] * dpre0).sum((0, 1))[None], X_n.T @ dpa, dK0e])

    # ---- the edge features: [q_m, |p_m|, <p_n, r>, <p_m, r>]
    dpp, dpn = dE[..., 2 * S : 3 * S], dE[..., 3 * S :]
    dp_m = (_norm_grad(dE[..., S : 2 * S], sq_m, nrm_m)[:, :, None] * p_m + dpn[:, :, None] * r_a[..., None]
            + torch.einsum("nhm,nxhs->nmxs", Mp[:, :, 2], gp))
    dr = dr + torch.einsum("nms,nxs->nmx", dpp, p) + torch.einsum("nms,nmxs->nmx", dpn, p_m)
    dp_n = (torch.einsum("nh,nxhs->nxs", Mp[:, :, 1].sum(2), gp) + torch.einsum("nms,nmx->nxs", dpp, r_a)
            + _norm_grad(dX[:, S:], sq_n, nrm_n)[:, None] * p)
    dqp = torch.zeros_like(qp)
    dqp.index_add_(0, m.reshape(-1), torch.cat([dE[..., :S], dp_m.reshape(n, nn, 3 * S)], 2).reshape(-1, 4 * S))
    dqp.index_add_(0, row0 + act, torch.cat([dX[:, :S], dp_n.reshape(n, 3 * S)], 1))

    def per_atom(x, like):
        full = torch.zeros_like(like)
        full[act] = x.to(like.dtype)
        return full

    grads = (dqp, per_atom((dpre0 * k0d).sum(2), d), per_atom(dr, r), per_atom(dnq, nq),
             dK0, dpa.sum(0), dK1, dpre1.sum((0, 1)), dK2, dout.sum((0, 1)))
    return tuple(g.to(qp.dtype) if want else None for g, want in zip(grads, need))


class EdgeAttentionFunction(torch.autograd.Function):
    """A forward without autograd history (the kernel) made differentiable.

    `apply(forward, S, Nh, Nk, qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2
    [, row0])` returns forward(qp, ..., B2, S, Nh, Nk, row0) and keeps only
    its inputs (row0, the atoms' first row of the table qp, is 0 when left
    out). Every input but ids and row0 is differentiable; qp's gradient
    covers the whole table. The backward launches
    `edge_attention_backward_kernel` on CUDA tensors (it raises if that
    fails: there is no fallback) and, on CPU tensors, reruns
    `edge_attention_plain` in their dtype under autograd; the profiler
    range `edge_attention_backward` names it in a trace."""

    @staticmethod
    def forward(ctx, forward, S, Nh, Nk, *inputs):
        *tensors, row0 = inputs if isinstance(inputs[-1], int) else (*inputs, 0)
        ctx.dims = (S, Nh, Nk, row0)
        ctx.save_for_backward(*tensors)
        return forward(*tensors, S, Nh, Nk, row0)

    @staticmethod
    def backward(ctx, grad_zq, grad_zp):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[4 : 4 + len(saved)]
        tail = (None,) * (len(ctx.needs_input_grad) - 4 - len(saved))  # row0
        with torch.profiler.record_function("edge_attention_backward"):
            if saved[0].is_cuda:
                g = edge_attention_backward_kernel(*saved, grad_zq.contiguous(), grad_zp.contiguous(),
                                                   *ctx.dims, need=need[:1] + need[2:])
                grads = g[:1] + (None,) + g[1:]
            else:
                inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, need)]
                with torch.enable_grad():
                    outs = edge_attention_plain(*inputs, *ctx.dims)
                    got = iter(torch.autograd.grad(outs, [t for t in inputs if t.requires_grad],
                                                   (grad_zq, grad_zp), allow_unused=True))
                grads = tuple(next(got) if t.requires_grad else None for t in inputs)
        return (None, None, None, None, *grads, *tail)


def fused_edge_attention(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3, row0=0):
    """(Zq [N, Nh*S], Zp [N, 3*Nh*S]) of one layer's N atoms.

    qp [N_table, 4S] = [q | p flattened x-major], the atoms' own rows at
    row0 .. row0 + N (N_table = N, row0 = 0 for a whole structure or
    batch; a larger table for one shard of a structure); ids [N, nn] rows
    of qp (int); d [N, nn]; r [N, nn, 3]; nq [N, 2*Nh*Nk] the nqm output.
    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises, through `EdgeAttentionFunction` while autograd records. Under
    `torch.export` (or `torch.compile`) the layer is one node of the
    operator `pesto_tpu_torch::edge_attention` (`edge_attention_op`),
    whose implementations are the same two; eager calls skip its dispatch,
    which costs ~40 us of host time per call on the H100's host (PERF.md)."""
    inputs = (qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2)
    if torch.compiler.is_compiling():
        return edge_attention_op(*inputs, S, Nh, Nk, row0)
    if _build.on_cuda(qp, "fused_edge_attention"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return EdgeAttentionFunction.apply(edge_attention_kernel, S, Nh, Nk, *inputs, row0)
        return edge_attention_kernel(*inputs, S, Nh, Nk, row0)
    return edge_attention_plain(*inputs, S, Nh, Nk, row0)


@torch.library.custom_op("pesto_tpu_torch::edge_attention", mutates_args=(), device_types="cpu")
def edge_attention_op(qp: torch.Tensor, ids: torch.Tensor, d: torch.Tensor, r: torch.Tensor,
                      nq: torch.Tensor, K0: torch.Tensor, B0: torch.Tensor, K1: torch.Tensor,
                      B1: torch.Tensor, K2: torch.Tensor, B2: torch.Tensor, S: int, Nh: int,
                      Nk: int, row0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge attention of one layer as a registered operator, for
    traced graphs and without a gradient: CPU tensors run
    `edge_attention_plain` (this body), CUDA tensors `edge_attention_kernel`
    (the CUDA implementation below); the fake implementation gives the
    output shapes to `torch.export`, whose graphs then hold the operator
    and not its body."""
    return edge_attention_plain(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0)


@edge_attention_op.register_kernel("cuda")
def _edge_attention_op_cuda(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0):
    # the module's name, looked up at each call: a test may swap the launcher
    return edge_attention_kernel(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0)


@edge_attention_op.register_fake
def _edge_attention_op_fake(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0):
    N = ids.shape[0]
    return qp.new_empty((N, Nh * S)), qp.new_empty((N, 3 * Nh * S))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# floats of the fp32 weights split into TF32 hi and lo (csrc/edge_attention.cu
# wg::SPLIT_FLOATS), which the fp32 kernel writes after the per-atom terms
_SPLIT_FLOATS = 55296
_EDGE = _build.Entry("edge_attention", "edge_attention", "i" + "p" * 14 + "iiii")
_NAMES = ("qp", "d", "r", "nq", "K0", "B0", "K1", "B1", "K2", "B2")


@functools.lru_cache(maxsize=64)
def _shapes(N, nn, n_table):
    """The shapes of qp, d, r, nq and the six weights, in `_NAMES` order."""
    S, Nh, Nk = 32, 2, 3  # the widths the kernel is built for
    return ((n_table, 4 * S), (N, nn), (N, nn, 3), (N, 2 * Nh * Nk), (6 * S + 1, 4 * S), (4 * S,),
            (4 * S, 4 * S), (4 * S,), (4 * S, 4 * Nk + 2 * S), (4 * Nk + 2 * S,))


def _check(name, qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0):
    """Raise ValueError on inputs the edge kernels do not take; returns
    (N, nn, n_table)."""
    if not qp.is_cuda:
        raise ValueError(f"{name}: needs CUDA tensors")
    if (S, Nh, Nk) != (32, 2, 3):
        raise ValueError(f"{name} is built for S=32, Nh=2, Nk=3, got {(S, Nh, Nk)}")
    if ids.dim() != 2:
        raise ValueError(f"{name}: ids must be [N, nn], got {tuple(ids.shape)}")
    N, nn = ids.shape
    if nn not in NN_SUPPORTED:
        raise ValueError(f"{name} takes nn in {NN_SUPPORTED}, got {nn}")
    dt = qp.dtype
    if dt not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {dt}")
    n_table = qp.shape[0]
    if not 0 <= row0 <= n_table - N:
        raise ValueError(f"{name}: rows {row0}..{row0 + N} lie outside a table of {n_table}")
    dev = qp.get_device()
    for what, x, shape in zip(_NAMES, (qp, d, r, nq, K0, B0, K1, B1, K2, B2), _shapes(N, nn, n_table)):
        if x.shape != shape or x.dtype != dt or x.get_device() != dev or not x.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous {dt} tensor of shape {shape} "
                f"on {qp.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if ids.dtype != torch.int32 or ids.get_device() != dev or not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous int32 tensor on the same device")
    if qp.data_ptr() % 16:
        raise ValueError(f"{name}: qp must be 16-byte aligned (its rows are copied 16 B at a time)")
    return N, nn, n_table


def edge_attention_kernel(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S=32, Nh=2, Nk=3, row0=0):
    """Launch csrc/edge_attention.cu (S=32, Nh=2, Nk=3; nn in 8/16/32/64)
    for the N = len(ids) atoms at rows row0 .. row0 + N of the table qp.
    One launch, counted once, runs its two kernels: the per-atom pre-pass
    and the tile kernel."""
    N, nn, n_table = _check("edge kernel", qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0)
    zq = qp.new_empty((N, Nh * S))
    zp = qp.new_empty((N, 3 * Nh * S))
    # scratch: the per-atom terms and, in fp32, the split weights
    per_atom = qp.new_empty(N * 4 * S + (_SPLIT_FLOATS if qp.dtype == torch.float32 else 0),
                            dtype=torch.float32)
    _EDGE(_DTYPES[qp.dtype], qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, per_atom,
          N, nn, row0, n_table)
    _build.count_launch(edge_attention_kernel)
    return zq, zp


edge_attention_kernel.launches = 0

_BWD = _build.Entry("edge_attention_bwd", "edge_attention_bwd", "i" + "p" * 24 + "i" * 6)
_BWD_SCRATCH = _build.Entry("edge_attention_bwd", "edge_attention_bwd_scratch", "iiii", host=True)


def edge_attention_backward_kernel(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, grad_zq, grad_zp,
                                   S=32, Nh=2, Nk=3, row0=0, need=(True,) * 10):
    """Launch csrc/edge_attention_bwd.cu: the VJP of the layer (the
    function of `edge_attention_backward_plain`) for the N = len(ids)
    atoms at rows row0 .. row0 + N of the table qp, given the gradients of
    Zq [N, Nh*S] and Zp [N, 3*Nh*S]. Returns the gradients of (qp, d, r,
    nq, K0, B0, K1, B1, K2, B2), None where `need` says no (the kernel
    writes d's, r's and nq's only where asked). One launch, counted once,
    runs its kernels: the per-atom pre-pass, in fp32 the weights' copy in
    fragment order, the tile kernel, the per-atom gradient, the
    fixed-order sum of the weight gradients' partials and, in bf16, the
    cast of the fp32 table gradient."""
    N, nn, n_table = _check("edge backward kernel", qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2,
                            S, Nh, Nk, row0)
    dt, dev = qp.dtype, qp.get_device()
    for what, g, width in (("grad_zq", grad_zq, Nh * S), ("grad_zp", grad_zp, 3 * Nh * S)):
        if g.shape != (N, width) or g.dtype != dt or g.get_device() != dev or not g.is_contiguous():
            raise ValueError(f"edge backward kernel: {what} must be a contiguous {dt} tensor of shape "
                             f"{(N, width)} on {qp.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    need = tuple(bool(x) for x in need)
    if len(need) != len(GRAD_NAMES):
        raise ValueError(f"edge backward kernel: need has one flag per gradient of {GRAD_NAMES}")
    # the kernel copies these 16 bytes at a time (qp's alignment is
    # checked above): a view that starts between two 16-byte boundaries
    # goes as an aligned copy
    ids, d, r, K0, K1, grad_zq, grad_zp = (
        x if x.data_ptr() % 16 == 0 else x.clone() for x in (ids, d, r, K0, K1, grad_zq, grad_zp))
    code = _DTYPES[dt]
    floats = _BWD_SCRATCH(code, N, nn, n_table)
    if not 0 <= floats < 2**31:
        raise ValueError(f"edge backward kernel: {floats} floats of scratch for N={N}, n_table={n_table}")
    scratch = torch.empty(floats, dtype=torch.float32, device=qp.device)
    # qp's and the weights' gradients always; d's, r's and nq's where needed
    outs = [torch.empty_like(x) if i not in (1, 2, 3) or need[i] else None
            for i, x in enumerate((qp, d, r, nq, K0, B0, K1, B1, K2, B2))]
    flags = need[1] | need[2] << 1 | need[3] << 2
    _BWD(code, qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, grad_zq, grad_zp,
         *(scratch if o is None else o for o in outs), scratch, N, nn, row0, n_table, flags, floats)
    _build.count_launch(edge_attention_backward_kernel)
    return tuple(o if want else None for o, want in zip(outs, need))


edge_attention_backward_kernel.launches = 0
