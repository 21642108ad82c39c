"""The plain reference of the PeSTo dimer: PyTorch in float32 or float64,
one unpadded pair at a time, no kernels, no batching.

The layer is the published CrossStateUpdateLayer (LBM-EPFL/PeSTo,
src/model_operations.py:245-334): a state update of each structure over
its own neighbours, then the scalar states of each structure attend over
every atom of the other (queries from `cqm`, keys `ckm / sqrt(cNk)`,
values `cvm`, two query heads sharing one key and one value row), and
`cpm` on [q, the heads' sums] gives the new scalar state; the vector
state is the state update's. The reference repository ships no model
that stacks it, so the stack is the one of the JAX package's dimer
(embedding, the layers, the residue pool and the decoder of
`reference/pesto.py`, all shared by both structures); parameter names are
the port's CrossPestoModel's (`em`, `csul.{i}.sul.su.*`,
`csul.{i}.c{q,k,v,p}m.*`, `spl`, `dm`).

Departures from the published layer, each exact up to rounding: the
structures are unpadded, so no bias masks a padding atom out of the
softmax (the published -1e6 bias gives exp(-1e6) = 0 in float32); the
softmax over the partner's atoms runs in blocks of query atoms
(`CROSS_BLOCK` logits at a time), so the largest pairs fit in float64; the
residue pool and the norms are `reference/pesto.py`'s.
"""

import math

import torch
from torch import nn

from .pesto import StatePool, StateUpdateLayer, geometry, mlp, safe_norm

CROSS_BLOCK = 1 << 25  # logits of one block of query atoms


def cross_attention(Q, K, V, block=CROSS_BLOCK):
    """qh [n, cNh * S] (head-major) of queries Q [n, cNh, cNk] over the
    partner's keys K [m, cNk] and values V [m, S]: a softmax over the
    partner's m atoms of Q . K / sqrt(cNk), in blocks of query atoms."""
    n, nh, nk = Q.shape
    k = K / math.sqrt(nk)
    step = max(1, block // (nh * max(1, K.shape[0])))
    out = []
    for a in range(0, n, step):
        w = torch.softmax(torch.einsum("nhk,mk->nhm", Q[a : a + step], k), dim=2)
        out.append(torch.einsum("nhm,ms->nhs", w, V).reshape(w.shape[0], -1))
    return torch.cat(out)


class CrossLayer(nn.Module):
    def __init__(self, S, Nh, Nk, nn_, cNh, cNk):
        super().__init__()
        self.cNh, self.cNk = cNh, cNk
        self.sul = StateUpdateLayer(S, Nh, Nk, nn_)
        self.cqm = mlp(2 * S, (S, S, cNk * cNh))
        self.ckm = mlp(2 * S, (S, S, cNk))
        self.cvm = mlp(2 * S, (S, S, S))
        self.cpm = mlp(S + cNh * S, (S, S, S))

    def forward(self, a, b):
        """a, b: (q, p, ids, d, r) of each structure -> ((q', p'), (q', p'))."""
        k = int(self.sul.m_nn.shape[0])
        upd = [self.sul.su(q, p, ids[:, :k], d[:, :k], r[:, :k]) for q, p, ids, d, r in (a, b)]
        s = [torch.cat([q, safe_norm(p, 1)], dim=1) for q, p in upd]
        Q = [self.cqm(x).reshape(x.shape[0], self.cNh, self.cNk) for x in s]
        K = [self.ckm(x) for x in s]
        V = [self.cvm(x) for x in s]
        qh = (cross_attention(Q[0], K[1], V[1]), cross_attention(Q[1], K[0], V[0]))
        return tuple((self.cpm(torch.cat([q, h], dim=1)), p) for (q, p), h in zip(upd, qh))


class CrossModel(nn.Module):
    """Embedding -> cross-state layers -> pool -> decoder, for both
    structures of a pair."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        S, Nh, Nk = cfg["Ns"], cfg["Nh"], cfg["Nk"]
        cNh, cNk = cfg["cross"]["cNh"], cfg["cross"]["cNk"]
        em = (cfg["em_n1"],) if cfg["em_single"] else (cfg["em_n1"],) * 3
        self.em = mlp(cfg["em_n0"], em)
        self.csul = nn.ModuleList(CrossLayer(S, Nh, Nk, k, cNh, cNk) for k in cfg["nn"])
        self.spl = StatePool(cfg["spl_n0"], cfg["spl_n1"], cfg["spl_nh"])
        dm = (cfg["dm_n2"],) if cfg["dm_single"] else (cfg["dm_n1"], cfg["dm_n1"], cfg["dm_n2"])
        self.dm = mlp(2 * cfg["spl_n1"], dm)

    def forward(self, a, b):
        """a, b: (q0 [n,F], ids [n,64], d [n,64], r [n,64,3], res [n], n_res)
        of each structure -> (logits [n_res_a, C], logits [n_res_b, C])."""
        z = [(self.em(q0), ids, d, r) for q0, ids, d, r, _, _ in (a, b)]
        z = [(q, q.new_zeros(q.shape[0], 3, q.shape[1]), ids, d, r) for q, ids, d, r in z]
        for layer in self.csul:
            (qa, pa), (qb, pb) = layer(z[0], z[1])
            z = [(qa, pa, *z[0][2:]), (qb, pb, *z[1][2:])]
        out = []
        for (q, p, *_), (*_, res, n_res) in zip(z, (a, b)):
            qr, pr = self.spl(q, p, res, n_res)
            out.append(self.dm(torch.cat([qr, safe_norm(pr, 1)], dim=1)))
        return out[0], out[1]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The state dict of a seed, made on `device` in one call, seeded as
    `reference.pesto.make_weights` seeds the single-structure model: every
    Linear's weight uniform with variance 1/fan_in, its bias uniform in
    +-1/sqrt(fan_in), in the state dict's order from one generator; and the
    buffers."""
    with torch.device("meta"):
        shapes = {k: v for k, v in CrossModel(cfg).state_dict().items()}
    params = [k for k in shapes if k.endswith((".weight", ".bias"))]
    total = sum(shapes[k].numel() for k in params)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    sd, at = {}, 0
    for k in params:
        shp = shapes[k].shape
        fan_in = shapes[k.rsplit(".", 1)[0] + ".weight"].shape[1]
        scale = math.sqrt((3.0 if k.endswith(".weight") else 1.0) / fan_in)
        sd[k] = (flat[at : at + shp.numel()].reshape(shp) * scale).clone()
        at += shp.numel()
    for k, v in shapes.items():
        if k.endswith(".m_nn"):
            sd[k] = torch.arange(v.shape[0], dtype=torch.int64, device=device)
        elif k.endswith(".sdk"):
            sd[k] = torch.tensor(math.sqrt(cfg["Nk"]), device=device)
    return sd


def side(model: CrossModel, X, ids, q0, res, n_res: int, device):
    """One structure's inputs to `CrossModel.forward` in the model's dtype,
    from coordinates [n,3], neighbour ids [n,64], features [n,F] and
    residue indices [n]."""
    dt = next(model.parameters()).dtype
    X = torch.as_tensor(X).to(device, torch.float32).to(dt)
    ids = torch.as_tensor(ids).to(device)
    d, r = geometry(X, ids)
    return torch.as_tensor(q0).to(device, dt), ids, d, r, torch.as_tensor(res).to(device), n_res
