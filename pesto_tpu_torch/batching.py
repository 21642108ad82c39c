"""Padding, size-bucketing and batch collation (port of
`pesto_tpu/batching.py`).

Every structure is padded into a fixed (atom-bucket, residue-bucket) shape:

  - row 0 = the sink slot (the reference's zero-padding target for
    missing neighbours),
  - rows 1..n = real atoms,
  - rows n+1.. = padding, handled like the sink by masking.

Padding runs on the host in numpy; the topology runs on the device that
the caller names. The one-hot gather tables and `BatchEncoder` of the JAX
package are not part of this slice.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .device import resolve_device
from .encoding import encode_features, encode_structure
from .ops.knn import knn_ids

# atoms include the +1 sink row
ATOM_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 8448, 16384, 32768, 65536, 131072)
RES_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
NUM_NN = 64


def pick_bucket(n: int, ladder) -> int:
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {ladder[-1]}")


@dataclasses.dataclass
class PaddedStructure:
    """A structure padded to static shapes; may carry a leading batch dim.
    Fields are numpy arrays or torch tensors."""

    X: Any          # [NA, 3] coords; row 0 sink, rows 1..n real
    ids_topk: Any   # [NA, K] int32 neighbour ids into padded rows (0 = sink)
    q: Any          # [NA, F] input features, or [NA] int32 codes
    M: Any          # [NA, NR] residue membership, or [NA] int32 codes
    atom_mask: Any  # [NA] 1.0 for real atoms
    res_mask: Any   # [NR] 1.0 for real residues


def pad_structure_arrays(X: np.ndarray, q: np.ndarray, M: np.ndarray,
                         na: Optional[int] = None, nr: Optional[int] = None,
                         num_nn: int = NUM_NN) -> PaddedStructure:
    """Pad unpadded (X [n,3], q [n,F], M [n,r]) into a PaddedStructure with
    dense q and M. The neighbour ids are zero until compute_topology()."""
    n, r = X.shape[0], M.shape[1]
    na = na or pick_bucket(n + 1, ATOM_BUCKETS)
    nr = nr or pick_bucket(r, RES_BUCKETS)
    if n + 1 > na or r > nr:
        raise ValueError(f"structure ({n} atoms, {r} res) exceeds bucket ({na},{nr})")

    Xp = np.zeros((na, 3), dtype=np.float32)
    Xp[1 : n + 1] = X
    qp = np.zeros((na, q.shape[1]), dtype=np.float32)
    qp[1 : n + 1] = q
    Mp = np.zeros((na, nr), dtype=np.float32)
    Mp[1 : n + 1, :r] = M
    am = np.zeros(na, dtype=np.float32)
    am[1 : n + 1] = 1.0
    rm = np.zeros(nr, dtype=np.float32)
    rm[:r] = 1.0
    ids = np.zeros((na, num_nn), dtype=np.int32)
    return PaddedStructure(X=Xp, ids_topk=ids, q=qp, M=Mp, atom_mask=am, res_mask=rm)


def compute_topology(ps: PaddedStructure, k: int = NUM_NN, device=None) -> PaddedStructure:
    """Fill ids_topk with the exact kNN ids (a tensor on `device`; None
    means the GPU). The model recomputes distances from the ids, so only
    the ids are computed: on the GPU the kernel runs no Dmax pass."""
    dev = resolve_device(device)
    X = torch.as_tensor(ps.X, dtype=torch.float32).to(dev)
    am = torch.as_tensor(ps.atom_mask, dtype=torch.float32).to(dev)
    ids, _ = knn_ids(X[None], am[None], k)
    return dataclasses.replace(ps, ids_topk=ids[0])


def encode_and_pad(
    structure: dict,
    feature_flags=(True, False, False),
    na: Optional[int] = None,
    nr: Optional[int] = None,
    device=None,
) -> PaddedStructure:
    """Structure record -> padded arrays (+ the kNN ids on `device`).

    feature_flags selects (qe, qr, qn) like the reference data handler
    (model/data_handler.py:37-43); the flagship models use element-only.
    """
    X, M = encode_structure(structure)
    feats = encode_features(structure)
    q = np.concatenate([f for f, flag in zip(feats, feature_flags) if flag], axis=1)
    ps = pad_structure_arrays(X, q, M, na=na, nr=nr)
    return compute_topology(ps, device=device)


def stack_batch(structures: list) -> PaddedStructure:
    """Stack same-bucket PaddedStructures into a batch (leading dim B):
    numpy when every field is numpy, torch tensors otherwise."""
    if not structures:
        raise ValueError("empty batch")
    shapes = {(tuple(s.X.shape), tuple(s.M.shape)) for s in structures}
    if len(shapes) != 1:
        raise ValueError(f"mixed bucket shapes in batch: {shapes}")
    fields = ("X", "ids_topk", "q", "M", "atom_mask", "res_mask")
    all_np = all(isinstance(getattr(s, f), np.ndarray) for s in structures for f in fields)

    def stack(vals):
        if all_np:
            return np.stack(vals)
        dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
        return torch.stack([torch.as_tensor(v).to(dev) for v in vals])

    return PaddedStructure(**{f: stack([getattr(s, f) for s in structures]) for f in fields})
