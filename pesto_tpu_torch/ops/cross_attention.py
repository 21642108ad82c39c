"""Cross attention of the dimer's CrossStateUpdateLayer: the CUDA kernel
`csrc/cross_attention.cu`, its plain version, and the launch counter.

It replaces no TPU kernel: the JAX package writes the layer's attention
between two structures as einsums over the padded [N, Nh, M] logits with
a -1e6 bias on the partner's padding (pesto_tpu/models/extras.py). Here
the rows of a batch of pairs lie in one table, and the attention takes
segments of it: segment s is the rows offsets[s] .. offsets[s] +
counts[s] (a structure's real atoms), and each of its rows attends over
the rows of segment partner[s], both heads sharing one key and one value
row:

    qh[i, h*S:(h+1)*S] = softmax_j(Q[i, h] . K[j] / sqrt(cNk)) @ V[j]

Padding is skipped, not biased (the bias's exp(-1e6) is exactly 0 in
float32), and rows outside every segment come out zero. The kernel keeps
an online softmax over the partner's rows in key tiles and never holds the
logits in memory; its source note says what bounds it and how it is laid
out. While autograd records, `cross_attention` runs the kernel inside
`CrossAttentionFunction`, whose backward reruns the plain version under
autograd (no backward kernel yet). CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""

import math

import torch

from . import _build

S, CNH, CNK = 32, 2, 3  # the widths the kernel is built for
PLAIN_BLOCK = 1 << 24  # logits a block of the plain version holds


def _ints(x):
    return x.tolist() if torch.is_tensor(x) else [int(v) for v in x]


def cross_attention_plain(Q, K, V, offsets, counts, partner):
    """Plain PyTorch version: Q [N, cNh, cNk], K [N, cNk], V [N, S], and
    per segment its first row, its row count and its partner segment
    (tensors or sequences of ints). Returns qh [N, cNh * S] (head, state)
    in Q's dtype: the softmax over the partner's rows, in blocks of query
    rows of at most PLAIN_BLOCK logits; zero on rows outside every segment
    and where the partner has no row."""
    N, nh, nk = Q.shape
    out = Q.new_zeros((N, nh * V.shape[1]))
    offs, cnts, prt = _ints(offsets), _ints(counts), _ints(partner)
    sdk = math.sqrt(nk)
    for o, c, t in zip(offs, cnts, prt):
        kc = cnts[t]
        if c == 0 or kc == 0:
            continue
        k = K[offs[t] : offs[t] + kc] / sdk
        v = V[offs[t] : offs[t] + kc]
        step = max(1, PLAIN_BLOCK // (nh * kc))
        for a in range(o, o + c, step):
            b = min(o + c, a + step)
            w = torch.softmax(torch.einsum("nhk,mk->nhm", Q[a:b], k), dim=2)
            out[a:b] = torch.einsum("nhm,ms->nhs", w, v).reshape(b - a, -1)
    return out


_CROSS = _build.Entry("cross_attention", "cross_attention", "p" * 7 + "ii")


def _check(Q, K, V, offsets, counts, partner):
    """Raise ValueError on inputs the kernel does not take."""
    if not Q.is_cuda:
        raise ValueError("cross attention kernel: needs CUDA tensors")
    if Q.dim() != 3 or Q.shape[1:] != (CNH, CNK):
        raise ValueError(f"cross attention kernel: Q must be [N, {CNH}, {CNK}], got {tuple(Q.shape)}")
    N = Q.shape[0]
    dev = Q.get_device()
    for what, x, shape in (("Q", Q, (N, CNH, CNK)), ("K", K, (N, CNK)), ("V", V, (N, S))):
        if x.shape != shape or x.dtype != torch.float32 or x.get_device() != dev or not x.is_contiguous():
            raise ValueError(f"cross attention kernel: {what} must be a contiguous float32 CUDA tensor of "
                             f"shape {shape} on {Q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    segs = offsets.shape
    for what, x in (("offsets", offsets), ("counts", counts), ("partner", partner)):
        if (x.dim() != 1 or x.shape != segs or x.dtype != torch.int32 or x.get_device() != dev
                or not x.is_contiguous()):
            raise ValueError(f"cross attention kernel: {what} must be a contiguous int32 [segments] "
                             f"tensor on {Q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 0 < segs[0] <= 65535:
        raise ValueError(f"cross attention kernel: 1 to 65535 segments, got {segs[0]}")


def cross_attention_kernel(Q, K, V, offsets, counts, partner, max_rows):
    """Launch csrc/cross_attention.cu: `cross_attention_plain`'s function on
    float32 CUDA tensors, with int32 segment tensors on the same card.
    `max_rows`, a host int, bounds every count (the grid's width), so the
    launch reads nothing back from the card. One launch, counted once."""
    _check(Q, K, V, offsets, counts, partner)
    if V.data_ptr() % 16:
        V = V.clone()  # rows are copied 16 bytes at a time
    out = Q.new_zeros((Q.shape[0], CNH * S))
    _CROSS(Q, K, V, offsets, counts, partner, out, offsets.shape[0], int(max_rows))
    _build.count_launch(cross_attention_kernel)
    return out


cross_attention_kernel.launches = 0


class CrossAttentionFunction(torch.autograd.Function):
    """The kernel's forward; the backward reruns the plain version under
    autograd on the saved inputs."""

    @staticmethod
    def forward(ctx, Q, K, V, offsets, counts, partner, max_rows):
        ctx.save_for_backward(Q, K, V, offsets, counts, partner)
        return cross_attention_kernel(Q, K, V, offsets, counts, partner, max_rows)

    @staticmethod
    def backward(ctx, grad):
        Q, K, V, offsets, counts, partner = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (Q, K, V)]
            out = cross_attention_plain(*inputs, offsets, counts, partner)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None, None, None, None)


def cross_attention(Q, K, V, offsets, counts, partner, max_rows):
    """qh [N, cNh * S] of the segments' cross attention (see the module
    note): the plain version on CPU tensors, the kernel on CUDA tensors
    (inside `CrossAttentionFunction` while autograd records); max_rows
    bounds every count."""
    if not _build.on_cuda(Q, "cross_attention"):
        return cross_attention_plain(Q, K, V, offsets, counts, partner)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (Q, K, V)):
        return CrossAttentionFunction.apply(Q, K, V, offsets, counts, partner, max_rows)
    return cross_attention_kernel(Q, K, V, offsets, counts, partner, max_rows)
