"""Auxiliary model operations of the reference that the flagship model does
not use (port of `pesto_tpu/models/extras.py`):

  - state_max_pool: masked max pooling of scalar/vector states to residues
    (reference src/model_operations.py:157-168);
  - CrossStateUpdateLayer: runs a StateUpdateLayer on two structures and
    cross-attends their pooled scalar states
    (reference src/model_operations.py:245-334, experimental).
"""

import torch
from torch import nn

from ..ops.cross_attention import cross_attention
from .config import LayerConfig
from .pesto import MLP3, StateUpdateLayer, safe_norm


def state_max_pool(q, p, M):
    """Masked max-pool of atom states to residues.

    q: [N,S], p: [N,3,S], M: [N,R] 0/1 mask. Returns (q_max [R,S],
    p_max [R,3,S]) where p_max takes, per (residue, channel), the vector of
    the atom whose masked vector norm is maximal, the first such atom on a
    tie, matching the reference's gather-by-argmax
    (src/model_operations.py:157-168). The maximum runs over every atom with
    non-members at 0, so a residue whose members are all negative pools to
    0, as in the reference."""
    # the reference norms over the *channel* axis (pt.norm(p, dim=2)),
    # selecting the max-magnitude atom per (residue, xyz component)
    s = safe_norm(p, 2)  # [N,3]
    Mq = M[:, :, None]  # [N,R,1]
    q_max = torch.amax(Mq * q[:, None, :], dim=0)  # [R,S]
    s_ids = torch.argmax(Mq * s[:, None, :], dim=0)  # [R,3]
    idx = s_ids[:, :, None].expand(s_ids.shape + (p.shape[2],))
    return q_max, torch.gather(p, 0, idx)  # [R,3,S]


class CrossStateUpdateLayer(nn.Module):
    """Per-structure geometric update + cross-attention between the scalar
    states of two structures (reference CrossStateUpdateLayer,
    src/model_operations.py:245-334).

    The geometric update is the port's StateUpdateLayer, shared by both
    structures: on a card its edge attention is the CUDA kernel (inside its
    autograd Function when a gradient is taken); on the CPU `fused` picks
    the packed plain version or the literal one. The cross-attention is the
    op `ops.cross_attention` over the rows of one table: the CUDA kernel on
    a card, its plain version on the CPU. A structure's real atoms are its
    rows 1..n after its sink row 0 (the padded layout of `batching`); the
    attention skips the partner's padding rather than biasing it, which is
    the same in float32 (exp(-1e6) is 0)."""

    def __init__(self, lc: LayerConfig, cNh: int = 2, cNk: int = 3, fused: bool = True):
        super().__init__()
        S = lc.Ns
        self.cNh, self.cNk = cNh, cNk
        self.sul = StateUpdateLayer(lc, fused)
        self.cqm = MLP3(2 * S, (S, S, cNk * cNh))
        self.ckm = MLP3(2 * S, (S, S, cNk))
        self.cvm = MLP3(2 * S, (S, S, S))
        self.cpm = MLP3(S + cNh * S, (S, S, S))

    def forward(self, Z0, Z1):
        """Z0/Z1: (q, p, ids_topk, D_nn, R_nn, atom_mask) per structure, the
        JAX package's entry. Returns ((q0', p0'), (q1', p1')): `pairs` over
        one table of both structures' rows, Z1's ids shifted past Z0's."""
        n0 = Z0[0].shape[0]
        q, p, ids, D, R, am = (torch.cat([a, b]) for a, b in zip(Z0, (*Z1[:2], Z1[2] + n0, *Z1[3:])))
        dev = q.device
        segments = (torch.tensor([1, n0 + 1], dtype=torch.int32, device=dev),
                    torch.stack([Z0[5].sum(), Z1[5].sum()]).to(torch.int32),
                    torch.tensor([1, 0], dtype=torch.int32, device=dev), max(n0, Z1[0].shape[0]) - 1)
        q, p = self.pairs(q, p, ids, D, R, am, segments)
        return (q[:n0], p[:n0]), (q[n0:], p[n0:])

    def pairs(self, q, p, ids_topk, D_nn, R_nn, atom_mask, segments):
        """One layer over a table of both sides' rows of a batch of pairs
        (`CrossPestoModel`'s batched forward): the shared geometric update
        once over every row (one edge launch), then the cross attention of
        `segments` = (offsets, counts, partner, max_rows) as `cross`
        takes them. Returns (q', p')."""
        qa, pz = self.sul(q, p, ids_topk, D_nn, R_nn, atom_mask)
        return self.cross(qa, pz, atom_mask, segments), pz

    def cross(self, qa, pz, atom_mask, segments):
        """The cross attention and its output MLP over a table's rows:
        segment s (rows offsets[s] .. offsets[s] + counts[s], int32 tensors
        on the rows' device) attends over the rows of segment partner[s];
        max_rows bounds every count. The sink and padding rows come out
        zero (the next layer's neighbour gather takes the state at a
        structure's row 0 to be zero)."""
        Nh, Nk = self.cNh, self.cNk
        s = torch.cat([qa, safe_norm(pz, 1)], dim=1)
        N = s.shape[0]
        Q = self.cqm(s).reshape(N, Nh, Nk)
        offsets, counts, partner, max_rows = segments
        f32 = [x.to(torch.float32).contiguous() for x in (Q, self.ckm(s), self.cvm(s))]
        qh = cross_attention(*f32, offsets, counts, partner, max_rows).to(qa.dtype)
        return self.cpm(torch.cat([qa, qh], dim=1)) * atom_mask.to(qa.dtype)[:, None]
