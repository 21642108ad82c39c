"""Paired-structure (dimer) model built on CrossStateUpdateLayer (port of
`pesto_tpu/models/cross.py`).

The reference ships CrossStateUpdateLayer unused by any model
(src/model_operations.py:245-334, "experimental"); this exposes it end to
end: two structures are embedded, run through a stack of cross-state
layers (per-structure geometric update + scalar-state cross-attention),
pooled to residues, and decoded to per-residue interface logits, each
conditioned on the partner. For training partner-specific interface
predictors; no reference weights exist for it.

Each side is a batch of padded structures ([B, NA, ...], the sides in
their own buckets), or one structure ([NA, ...]), which runs as a batch of
one pair. Both sides' rows lie in one table: each layer runs the edge
attention once over every row (the geometric update is shared by both
sides, so this is exact per atom) and the cross attention once for both
directions of every pair (`Predictor.predict_pairs`'s path).
"""

import torch
from torch import nn

from .config import PestoConfig
from .extras import CrossStateUpdateLayer
from .pesto import MLP3, StatePool, embed_batch, safe_norm


class CrossPestoModel(nn.Module):
    """Dimer model: (structure A, structure B) -> per-residue logits for
    both, each conditioned on the other via cross-attention. `em`, the
    layers `csul.{i}`, `spl` and `dm` are shared by both structures."""

    def __init__(self, cfg: PestoConfig):
        super().__init__()
        self.cfg = cfg
        em = (cfg.em_n1,) if cfg.em_single else (cfg.em_n1, cfg.em_n1, cfg.em_n1)
        self.em = MLP3(cfg.em_n0, em)
        self.csul = nn.ModuleList(CrossStateUpdateLayer(lc, fused=cfg.fused_edges) for lc in cfg.layers)
        self.spl = StatePool(cfg.spl_n0, cfg.spl_n1, cfg.spl_nh)
        dm = (cfg.dm_n2,) if cfg.dm_single else (cfg.dm_n1, cfg.dm_n1, cfg.dm_n2)
        self.dm = MLP3(2 * cfg.spl_n1, dm)

    def forward(self, A, B, nr_a=None, nr_b=None):
        """A/B: (X, ids_topk, q0, M, atom_mask) per side, padded with sink
        row 0 and real atoms at rows 1..n. A batch of pairs: each side [B,
        NA_side, ...], q0 and M dense or integer codes as `PestoModel.
        forward` takes them (nr_a, nr_b for compact M); returns (zA [B, NRa,
        C], zB [B, NRb, C]). One pair: X [NA, 3], ids_topk [NA, K], q0 [NA,
        F], M [NA, NR], atom_mask [NA], run as a batch of one; returns (zA
        [NRa, C], zB [NRb, C])."""
        if A[0].dim() == 3:
            return self._pairs(A, B, nr_a, nr_b)
        zA, zB = self._pairs(tuple(t[None] for t in A), tuple(t[None] for t in B), nr_a, nr_b)
        return zA[0], zB[0]

    def _pairs(self, A, B, nr_a, nr_b):
        """The batched forward: side A's rows, then side B's, in one table."""
        Bn, NA_a = A[0].shape[:2]
        NA_b = B[0].shape[1]
        if B[0].shape[0] != Bn:
            raise ValueError(f"a batch of pairs needs as many B sides as A sides, got {Bn} and {B[0].shape[0]}")
        qa, pa, ids_a, Da, Ra, ama, Ma, na = embed_batch(self.cfg, self.em, *A, nr=nr_a)
        qb, pb, ids_b, Db, Rb, amb, Mb, nb = embed_batch(self.cfg, self.em, *B, nr=nr_b, row0=Bn * NA_a)
        q, p = torch.cat([qa, qb]), torch.cat([pa, pb])
        ids, D, R, am = (torch.cat(x) for x in ((ids_a, ids_b), (Da, Db), (Ra, Rb), (ama, amb)))
        # segment b: side A of pair b, partner Bn + b; segment Bn + b: its side B
        first = torch.arange(Bn, dtype=torch.int32, device=q.device)
        segments = (torch.cat([first * NA_a + 1, first * NA_b + (Bn * NA_a + 1)]),
                    torch.cat([na, nb]).to(torch.int32), torch.cat([first + Bn, first]),
                    max(NA_a, NA_b) - 1)
        for layer in self.csul:
            q, p = layer.pairs(q, p, ids, D, R, am, segments)
        out = []
        for rows, NA, M in ((slice(0, Bn * NA_a), NA_a, Ma), (slice(Bn * NA_a, None), NA_b, Mb)):
            qr, pr = self.spl(q[rows].reshape(Bn, NA, -1), p[rows].reshape(Bn, NA, 3, -1), M)
            out.append(self.dm(torch.cat([qr, safe_norm(pr, -2)], dim=-1)))
        return out[0], out[1]
