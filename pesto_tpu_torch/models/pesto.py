"""The geometric transformer as torch.nn.Modules (port of
`pesto_tpu/models/pesto.py`).

Operates on padded structures (row 0 = sink, masked padding) or batches of
them; batches are flattened into the atom axis for the layer stack, with
each structure's neighbour ids shifted into its own row range. Neighbour
geometry is recomputed from coordinates and ids with the reference's
index-wrap rule for missing-neighbour slots.

Module and buffer names follow the reference torch model (`em.0`,
`sum.{i}.su.nqm.0`, ..., `spl.zdm_vec.0`, `dm.4`, buffers `sum.{i}.m_nn`
and `sum.{i}.su.sdk`), so a reference state dict loads with strict=True.

On a CUDA device every StateUpdate runs the fused edge-attention kernel
(`ops.edge_attention`), in training too: while autograd records, the
kernel runs inside `EdgeAttentionFunction`, whose backward is the edge
backward kernel (`csrc/edge_attention_bwd.cu`). On the CPU, `cfg.fused_edges` picks
the packed plain version or the literal one (reference StateUpdate,
src/model_operations.py:26-154).
"""

import math

import torch
from torch import nn

from ..ops.edge_attention import fused_edge_attention, safe_norm
from .config import LayerConfig, PestoConfig

__all__ = ["safe_norm", "MLP3", "unpack_state_features", "neighbour_vectors",
           "finish_state_features", "StateUpdate",
           "StateUpdateLayer", "StatePool", "onehot_codes", "embed_batch", "PestoModel"]


def MLP3(n_in: int, features) -> nn.Sequential:
    """Linear-ELU-Linear-ELU-Linear (or a single Linear), keyed 0/2/4 like
    the reference's nn.Sequential."""
    mods = []
    for i, f in enumerate(features):
        mods.append(nn.Linear(n_in, f))
        if i + 1 < len(features):
            mods.append(nn.ELU())
        n_in = f
    return nn.Sequential(*mods)


def unpack_state_features(X, ids_topk, atom_mask, n_real):
    """Per-neighbour distances and unit displacements from coordinates.

    X [B,NA,3], ids_topk [B,NA,K] padded-row ids (0 = sink), atom_mask
    [B,NA], n_real [B]. Matches the reference (src/model_operations.py:6-22)
    on the padded layout: a missing-neighbour slot (id 0) resolves, like
    the reference's `X[ids_topk-1]` with its negative-index wrap, to the
    last real atom for the geometry, while the gathered *state* at id 0 is
    the zero sink."""
    R, D, Dmax = neighbour_vectors(X, ids_topk, atom_mask, n_real)
    return finish_state_features(R, D, Dmax, atom_mask)


def neighbour_vectors(X, ids_topk, atom_mask, n_real, row0=0):
    """(R, D, Dmax) of the rows row0 .. row0 + n of X, whose ids_topk
    [B, n, K] and atom_mask [B, n] are given: the displacements to their
    neighbours [B, n, K, 3], their lengths, and the largest length over
    those rows' real atoms [B] (-inf for none). Dmax is the structure's
    over all of its rows: a shard of a structure reduces it across the
    shards before `finish_state_features`."""
    B, NA, _ = X.shape
    n = torch.clamp(n_real, min=1).to(ids_topk.dtype)[:, None, None]
    i_raw = torch.remainder(ids_topk - 1, n)  # id >= 1 -> id-1; id 0 -> n-1
    idx = torch.clamp(i_raw + 1, 0, NA - 1).long()
    bidx = torch.arange(B, device=X.device)[:, None, None]
    R = X[bidx, idx] - X[:, row0 : row0 + ids_topk.shape[1], None, :]
    D = safe_norm(R, -1)
    row = atom_mask[:, :, None]
    Dmax = torch.where(row > 0, D, torch.full_like(D, -math.inf)).amax(dim=(1, 2))
    return R, D, Dmax


def finish_state_features(R, D, Dmax, atom_mask):
    """(D, R) of `unpack_state_features` from `neighbour_vectors`: a
    distance under 1e-2 moved out by the structure's Dmax, unit
    displacements, zeros on the sink and padding rows."""
    row = atom_mask[:, :, None]
    Dmax = torch.clamp(Dmax, min=0.0)[:, None, None]
    D = D + Dmax * (D < 1e-2).to(D.dtype)
    R = R / torch.clamp(D, min=1e-12)[..., None]
    # sink and padding rows carry zeros (the reference prepends a zero row)
    return D * row, R * row[..., None]


class StateUpdate(nn.Module):
    """One rotation-invariant attention update of the scalar state q [N,S]
    and the vector state p [N,3,S] over each atom's nn nearest neighbours."""

    def __init__(self, lc: LayerConfig, fused: bool = True):
        super().__init__()
        S, Nh, Nk = lc.Ns, lc.Nh, lc.Nk
        self.S, self.Nh, self.Nk, self.fused = S, Nh, Nk, fused
        self.nqm = MLP3(2 * S, (S, S, 2 * Nk * Nh))
        self.eqkm = MLP3(6 * S + 1, (S, S, Nk))
        self.epkm = MLP3(6 * S + 1, (S, S, 3 * Nk))
        self.evm = MLP3(6 * S + 1, (2 * S, 2 * S, 2 * S))
        self.qpm = MLP3(Nh * S, (S, S, S))
        self.ppm = nn.Sequential(nn.Linear(Nh * S, S, bias=False))
        self.register_buffer("sdk", torch.sqrt(torch.tensor(float(Nk))))
        self._packed = None  # (weight version counters, packed weights)

    def packed_weights(self):
        """(K0, B0, K1, B1, K2, B2) of the three edge MLPs packed as in
        pesto_tpu/models/pesto.py:233-275 (torch [out,in] -> [in,out]).

        The packing is kept between calls and redone when a weight changes:
        in place (its version counter moves, as under load_state_dict or an
        optimiser step) or by a move to another device or dtype (`_apply`).
        It is redone on every call while autograd records, so that the
        gradients reach the three MLPs, and when the weights are tensors put
        in place of the parameters (`torch.func.functional_call`, as the
        trainer's bf16 compute does)."""
        mlps = (self.eqkm, self.epkm, self.evm)
        weights = [getattr(m[i], k) for m in mlps for i in (0, 2, 4) for k in ("weight", "bias")]
        if (torch.is_grad_enabled() and any(w.requires_grad for w in weights)) or not all(
                isinstance(w, nn.Parameter) for w in weights):
            return self._pack(mlps)
        key = tuple(w._version for w in weights)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, self._pack(mlps))
        return self._packed[1]

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    @staticmethod
    def _pack(mlps):
        K0 = torch.cat([m[0].weight.T for m in mlps], dim=1)
        B0 = torch.cat([m[0].bias for m in mlps])
        K1 = torch.block_diag(*[m[2].weight.T for m in mlps])
        B1 = torch.cat([m[2].bias for m in mlps])
        K2 = torch.block_diag(*[m[4].weight.T for m in mlps])
        B2 = torch.cat([m[4].bias for m in mlps])
        return tuple(w.contiguous() for w in (K0, B0, K1, B1, K2, B2))

    def forward(self, q, p, qp, ids, d_nn, r_nn, row0=0):
        """q [N,S], p [N,3,S], qp = [q | p flat] [N,4S], ids [N,nn] rows of
        qp, d_nn [N,nn], r_nn [N,nn,3] -> (q', p'). For one shard of a
        structure, qp is the whole structure's table and q, p are its rows
        row0 .. row0 + N."""
        N, S, Nh = q.shape[0], self.S, self.Nh
        if q.is_cuda or self.fused:
            Q = self.nqm(torch.cat([q, safe_norm(p, 1)], dim=1))
            Zq, Zp = fused_edge_attention(
                qp, ids, d_nn.contiguous(), r_nn.contiguous(), Q.contiguous(),
                *self.packed_weights(), S=S, Nh=Nh, Nk=self.Nk, row0=row0,
            )
            Zp = Zp.reshape(N, 3, Nh * S)
        else:
            Zq, Zp = self._literal(q, p, qp, ids, d_nn, r_nn)
        return q + self.qpm(Zq), p + self.ppm(Zp)

    def _literal(self, q, p, qp, ids, d_nn, r_nn):
        """The reference's computation with the [N,nn,6S+1] edge tensor and
        the [N,3,3nn,S] vector values built out (CPU only)."""
        S, Nh, Nk = self.S, self.Nh, self.Nk
        N, n_nn = ids.shape
        qp_nn = qp[ids.long()]
        q_nn = qp_nn[..., :S]
        p_nn = qp_nn[..., S:].reshape(N, n_nn, 3, S)
        X_n = torch.cat([q, safe_norm(p, 1)], dim=1)
        p_proj = (p[:, None] * r_nn[..., None]).sum(dim=2)
        pnn_proj = (p_nn * r_nn[..., None]).sum(dim=2)
        X_e = torch.cat(
            [d_nn[..., None], X_n[:, None].expand(N, n_nn, 2 * S), q_nn,
             safe_norm(p_nn, 2), p_proj, pnn_proj],
            dim=2,
        )
        Q = self.nqm(X_n).reshape(N, 2, Nh, Nk)
        Kq = self.eqkm(X_e)
        Kp = torch.cat(torch.split(self.epkm(X_e), Nk, dim=2), dim=1)  # [N,3nn,Nk]
        V = self.evm(X_e).reshape(N, n_nn, 2, S)
        V0, V1 = V[:, :, 0], V[:, :, 1]
        Vp = torch.cat(
            [V1[:, :, None] * r_nn[..., None], p[:, None].expand(N, n_nn, 3, S), p_nn],
            dim=1,
        ).transpose(1, 2)                                           # [N,3,3nn,S]
        Mq = torch.softmax(torch.einsum("nhk,nmk->nhm", Q[:, 0], Kq) / self.sdk, dim=2)
        Mp = torch.softmax(torch.einsum("nhk,nmk->nhm", Q[:, 1], Kp) / self.sdk, dim=2)
        Zq = torch.einsum("nhm,nms->nhs", Mq, V0).reshape(N, Nh * S)
        Zp = torch.einsum("nhm,nxms->nxhs", Mp, Vp).reshape(N, 3, Nh * S)
        return Zq, Zp


class StateUpdateLayer(nn.Module):
    """Take each atom's first nn neighbours, run StateUpdate, and re-zero
    the sink and padding rows (reference StateUpdateLayer)."""

    def __init__(self, lc: LayerConfig, fused: bool = True):
        super().__init__()
        self.nn = lc.nn
        self.su = StateUpdate(lc, fused)
        self.register_buffer("m_nn", torch.arange(lc.nn, dtype=torch.int64))

    def forward(self, q, p, ids_topk, D_nn, R_nn, atom_mask, table=None, row0=0):
        """table=None: q, p are every row that ids_topk names. For one
        shard of a structure, `table` is the structure's [q | p] rows
        gathered from every shard, and q, p are its rows row0 .. row0 + N."""
        N, S = q.shape
        k = self.nn
        if table is None:
            table = torch.cat([q, p.reshape(N, 3 * S)], dim=1).contiguous()
        q, p = self.su(q, p, table, ids_topk[:, :k].contiguous(), D_nn[:, :k], R_nn[:, :k], row0)
        # cast the mask, not the state: a float32 mask would upcast bf16
        am = atom_mask.to(q.dtype)
        return q * am[:, None], p * am[:, None, None]


class StatePool(nn.Module):
    """Atom -> residue multi-head attention pooling over the membership
    mask M (reference StatePoolLayer, src/model_operations.py:171-213)."""

    def __init__(self, N0: int, N1: int, Nh: int):
        super().__init__()
        self.Nh = Nh
        self.sam = MLP3(2 * N0, (N0, N0, 2 * Nh))
        self.zdm = MLP3(Nh * N0, (N0, N0, N1))
        self.zdm_vec = nn.Sequential(nn.Linear(Nh * N0, N1, bias=False))

    def _logits(self, q, p, M):
        """[B, NA, NR, 2Nh] float32 softmax logits of every (atom, residue,
        head): the filter is ~ +1e-6 for members, ~ -1e6 for non-members;
        the filter, the softmax and the pooled sums are float32 (M is), as
        under JAX's type promotion."""
        M = M.to(torch.float32)
        Fm = (1.0 - M + 1e-6) / (M - 1e-6)
        s = self.sam(torch.cat([q, safe_norm(p, -2)], dim=-1)).to(torch.float32)
        return s[:, :, None, :] + Fm[..., None]

    def forward(self, q, p, M):
        """q [B,NA,S], p [B,NA,3,S], M [B,NA,NR] -> ([B,NR,N1], [B,NR,3,N1]):
        the softmax over the atoms as the one-part case of the sharded
        pool, normalised after the weighted sums."""
        return self.merge([self.partial(q, p, M)], q.dtype)

    def _decode(self, qh, ph, dt):
        # flattening is (state, head)-major, as the reference's view()
        B, NR = qh.shape[:2]
        return (self.zdm(qh.reshape(B, NR, -1).to(dt)),
                self.zdm_vec(ph.reshape(B, NR, 3, -1).to(dt)))

    def partial(self, q, p, M):
        """One shard's part of the pooling over the atoms: its rows q, p,
        M of a structure give (max, sum of exponentials, the exp-weighted
        sums of q and of p), each per residue and head, with the
        exponentials taken against the shard's own max. `merge` combines
        the parts of every shard; no shard holds more than its own
        [B, n, NR, 2Nh] block."""
        B, n, NR = M.shape
        logits = self._logits(q, p, M)
        # the softmax does not depend on the max: no gradient through it,
        # and the exponentials overwrite the logits
        m = logits.detach().amax(dim=1)                           # [B, NR, 2Nh]
        e = logits.sub_(m[:, None]).exp_().reshape(B, n, NR, self.Nh, 2)
        wq = torch.einsum("bas,barh->brsh", q.to(torch.float32), e[..., 0])
        wp = torch.einsum("baxs,barh->brxsh", p.to(torch.float32), e[..., 1])
        return m, e.sum(dim=1), wq, wp

    def merge(self, parts, dt):
        """The pooled outputs from every shard's `partial`, on one device:
        each part rescaled from its max to the global one (a log-sum-exp
        merge), summed and normalised."""
        m = parts[0][0]
        for part in parts[1:]:
            m = torch.maximum(m, part[0])
        B, NR = m.shape[:2]
        den = qh = ph = 0.0
        for mk, lk, wq, wp in parts:
            c = torch.exp(mk - m).reshape(B, NR, self.Nh, 2)
            den = den + c * lk
            qh = qh + c[:, :, None, :, 0] * wq
            ph = ph + c[:, :, None, None, :, 1] * wp
        return self._decode(qh / den[:, :, None, :, 0], ph / den[:, :, None, None, :, 1], dt)


def onehot_codes(codes, width: int) -> torch.Tensor:
    """Integer feature codes of a batch as its float32 0/1 input features
    [B, NA, width]. codes [B, NA, V] hold one column per vocabulary, each
    code already offset to its vocabulary's columns of the concatenated
    one-hot, so one comparison serves any V; [B, NA] is one vocabulary's.
    An out-of-range code sets no column."""
    if codes.dim() == 2:
        codes = codes[..., None]
    return (codes[..., None] == torch.arange(width, device=codes.device)).any(-2).to(torch.float32)


def embed_batch(cfg: PestoConfig, em: nn.Module, X, ids_topk, q0, M, atom_mask, nr=None, row0: int = 0):
    """A batch [B, NA, ...] of padded structures as the layer stack's
    flattened inputs: (q [B*NA, S], p [B*NA, 3, S], ids [B*NA, K] int32,
    D_nn, R_nn, atom mask [B*NA], M [B, NA, NR] dense, real atoms [B]).
    q0 may be the dense one-hot features or integer feature codes
    (`onehot_codes`), and M the dense membership or integer residue codes
    (then `nr` is required); out-of-range codes expand to zero rows. Each
    structure's ids (its sink 0 included) shift into its own row range,
    which starts at row0 (another batch's rows may come first in the same
    table)."""
    dtype = em[0].weight.dtype
    B, NA = X.shape[:2]
    atom_mask = atom_mask.to(torch.float32)
    if not torch.is_floating_point(q0):
        q0 = onehot_codes(q0, cfg.em_n0)
    if not torch.is_floating_point(M):
        if nr is None:
            raise ValueError("compact M (residue codes) requires nr")
        M = (M[..., None] == torch.arange(nr, device=M.device)).to(torch.float32)
        M = M * atom_mask[..., None]

    X = X.to(torch.float32)
    n_real = atom_mask.sum(dim=1).to(torch.int64)
    D_nn, R_nn = unpack_state_features(X, ids_topk, atom_mask, n_real)
    offsets = (torch.arange(B, device=X.device, dtype=ids_topk.dtype) * NA)[:, None, None]
    if row0:
        offsets = offsets + row0
    ids_flat = (ids_topk + offsets).reshape(B * NA, -1).to(torch.int32)
    am = atom_mask.reshape(B * NA)
    D_nn = D_nn.reshape(B * NA, -1).to(dtype)
    R_nn = R_nn.reshape(B * NA, -1, 3).to(dtype)

    # embedding; sink/padding rows are zero *after* the MLP, like the
    # reference's zero-row prepend (model/model.py:34-40)
    q = em(q0.reshape(B * NA, -1).to(dtype))
    q = q * am.to(dtype)[:, None]
    p = torch.zeros((B * NA, 3, cfg.em_n1), dtype=dtype, device=X.device)
    return q, p, ids_flat, D_nn, R_nn, am, M, n_real


class PestoModel(nn.Module):
    """Embedding -> geometric transformer stack -> residue pool -> decoder
    (reference Model, model/model.py:6-52).

    forward takes one padded structure ([NA, ...]) or a batch ([B, NA, ...]).
    q0 may be the dense one-hot features or integer feature codes
    (`onehot_codes`: [..., NA] of one vocabulary or [..., NA, V]), and M
    the dense membership or integer residue codes (then `nr` is required);
    out-of-range codes expand to zero rows."""

    def __init__(self, cfg: PestoConfig):
        super().__init__()
        self.cfg = cfg
        em = (cfg.em_n1,) if cfg.em_single else (cfg.em_n1, cfg.em_n1, cfg.em_n1)
        self.em = MLP3(cfg.em_n0, em)
        self.sum = nn.ModuleList(StateUpdateLayer(lc, cfg.fused_edges) for lc in cfg.layers)
        self.spl = StatePool(cfg.spl_n0, cfg.spl_n1, cfg.spl_nh)
        dm = (cfg.dm_n2,) if cfg.dm_single else (cfg.dm_n1, cfg.dm_n1, cfg.dm_n2)
        self.dm = MLP3(2 * cfg.spl_n1, dm)

    def forward(self, X, ids_topk, q0, M, atom_mask, nr=None):
        batched = X.dim() == 3
        if not batched:
            X, ids_topk, q0, M, atom_mask = (t[None] for t in (X, ids_topk, q0, M, atom_mask))
        B, NA = X.shape[:2]
        q, p, ids_flat, D_nn, R_nn, am, M, _ = embed_batch(self.cfg, self.em, X, ids_topk, q0, M, atom_mask, nr)
        for layer in self.sum:
            q, p = layer(q, p, ids_flat, D_nn, R_nn, am)

        qr, pr = self.spl(q.reshape(B, NA, -1), p.reshape(B, NA, 3, -1), M)
        z = self.dm(torch.cat([qr, safe_norm(pr, -2)], dim=-1))
        return z if batched else z[0]
