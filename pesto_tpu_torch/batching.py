"""Padding, size-bucketing and batch collation (port of
`pesto_tpu/batching.py`).

Every structure is padded into a fixed (atom-bucket, residue-bucket) shape:

  - row 0 = the sink slot (the reference's zero-padding target for
    missing neighbours),
  - rows 1..n = real atoms,
  - rows n+1.. = padding, handled like the sink by masking.

Padding runs on the host in numpy (in the trainer's loader workers too,
which never touch the card); the topology runs on the device that the
caller names, and `to_device` moves a batch there. `BatchEncoder` fills
reused (on a card, pinned) batch buffers for the serving path and copies
them to the device; `encode_record` gives the integer codes of a record
that it takes (`record_sizes`, what its buckets need, joined with
`record_codes`, the coordinates and vocabulary codes), and `pad_record`
pads them alone. The one-hot gather
tables of the JAX package are not ported: the edge kernel gathers its
neighbour rows itself.
"""

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from .device import resolve_device
from .encoding import encode_features, encode_structure, std_elements, std_names, std_resnames, vocab_codes
from .ops.knn import knn_ids
from .spatial import morton_order
from .utils import tracing

# atoms include the +1 sink row
ATOM_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 8448, 16384, 32768, 65536, 131072)
RES_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
NUM_NN = 64
MAX_BATCH_SHAPES = 16  # buffer signatures a BatchEncoder keeps, least recently used dropped first


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
    y: Any = None   # [NR, C] labels (training only)

    @property
    def num_atoms(self):
        """Real atoms per structure, int32: a scalar unbatched, [B] batched.
        A numpy array for a numpy atom_mask; for a tensor, a tensor on its
        device (no host sync)."""
        if isinstance(self.atom_mask, torch.Tensor):
            return self.atom_mask.sum(dim=-1).to(torch.int32)
        return np.asarray(np.sum(self.atom_mask, axis=-1)).astype(np.int32)


FIELDS = ("X", "ids_topk", "q", "M", "atom_mask", "res_mask", "y")


def pad_structure_arrays(X: np.ndarray, q: np.ndarray, M: np.ndarray,
                         na: Optional[int] = None, nr: Optional[int] = None,
                         y: Optional[np.ndarray] = None,
                         ids_topk_raw: Optional[np.ndarray] = None,
                         num_nn: int = NUM_NN, compact: bool = False) -> PaddedStructure:
    """Pad unpadded (X [n,3], q [n,F], M [n,r]) into a PaddedStructure.

    ids_topk_raw (0-based neighbour ids [n, k<=num_nn], as a dataset stores
    them) is shifted into rows 1..n; without it the ids are zero until
    compute_topology(). y [r, C] is padded to [NR, C]. compact=True ships q
    and M as per-atom int32 codes ([NA]: vocabulary index, residue index;
    sink and padding rows carry the out-of-range code, which the model
    expands to a zero row), valid when q is a single one-hot vocabulary."""
    n, r = X.shape[0], M.shape[1]
    na = na or pick_bucket(n + 1, ATOM_BUCKETS)
    nr = nr or pick_bucket(r, RES_BUCKETS)
    if n + 1 > na or r > nr:
        raise ValueError(f"structure ({n} atoms, {r} res) exceeds bucket ({na},{nr})")

    Xp = np.zeros((na, 3), dtype=np.float32)
    Xp[1 : n + 1] = X
    if compact:
        qp = np.full(na, q.shape[1], dtype=np.int32)
        qp[1 : n + 1] = np.argmax(q, axis=1)
        Mp = np.full(na, nr, dtype=np.int32)
        Mp[1 : n + 1] = np.argmax(M, axis=1)
    else:
        qp = np.zeros((na, q.shape[1]), dtype=np.float32)
        qp[1 : n + 1] = q
        Mp = np.zeros((na, nr), dtype=np.float32)
        Mp[1 : n + 1, :r] = M
    am = np.zeros(na, dtype=np.float32)
    am[1 : n + 1] = 1.0
    rm = np.zeros(nr, dtype=np.float32)
    rm[:r] = 1.0
    ids = np.zeros((na, num_nn), dtype=np.int32)
    if ids_topk_raw is not None:
        ids[1 : n + 1, : ids_topk_raw.shape[1]] = ids_topk_raw + 1
    yp = None
    if y is not None:
        yp = np.zeros((nr, y.shape[1]), dtype=np.float32)
        yp[:r] = y
    return PaddedStructure(X=Xp, ids_topk=ids, q=qp, M=Mp, atom_mask=am, res_mask=rm, y=yp)


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


def compact_spec(cfg):
    """[(vocabulary, record field, offset)] of each feature vocabulary that
    the config's flags set, in the one-hot's order (elements, residue names,
    atom names): the offset is the vocabulary's first column of the
    concatenated one-hot, whose "other" column follows each vocabulary.
    ValueError when cfg.em_n0 is not their total width."""
    spec, offset = [], 0
    for flag, vocab, field in zip(cfg.feature_flags, (std_elements, std_resnames, std_names),
                                  ("element", "resname", "name")):
        if flag:
            spec.append((vocab, field, offset))
            offset += len(vocab) + 1
    if cfg.em_n0 != offset:
        raise ValueError(f"integer codes of the flagged vocabularies need em_n0 == {offset}, got {cfg.em_n0}")
    return spec


def record_sizes(s: dict):
    """The sizing part of `encode_record`: (atoms n, residue codes [n]
    int32, n_res), the codes `np.unique`'s inverse over resid. Enough for
    a record's buckets (`size_buckets`) and its answer's rows; ValueError
    for a record with no residue."""
    _, rid = np.unique(np.asarray(s["resid"]), return_inverse=True)
    return len(s["xyz"]), rid.astype(np.int32), int(rid.max()) + 1


def record_codes(s: dict, cfg):
    """The rest of `encode_record`: (X [n, 3] float32, codes [n, V] int32
    of `compact_spec(cfg)`, a column per vocabulary, offset into the
    one-hot's columns)."""
    X = np.asarray(s["xyz"], dtype=np.float32)
    spec = compact_spec(cfg)
    codes = np.empty((X.shape[0], len(spec)), np.int32)
    for k, (vocab, field, offset) in enumerate(spec):
        codes[:, k] = vocab_codes(s[field], vocab) + offset
    return X, codes


def encode_record(s: dict, cfg):
    """Structure record -> the host arrays `BatchEncoder` takes: (X [n, 3]
    float32, codes [n, V] int32, residue codes [n] int32, n_res), that is
    `record_codes` joined with `record_sizes`; the device expands both
    codes (`models.pesto.onehot_codes`)."""
    X, codes = record_codes(s, cfg)
    _, rid, n_res = record_sizes(s)
    return X, codes, rid, n_res


def size_buckets(n_atoms: int, n_res: int):
    """(atom bucket, residue bucket) of a record of n_atoms atoms (the sink
    row added) and n_res residues; ValueError past the largest."""
    return (pick_bucket(n_atoms + 1, ATOM_BUCKETS), pick_bucket(max(n_res, 1), RES_BUCKETS))


def record_buckets(rec):
    """`size_buckets` of an `encode_record` result."""
    return size_buckets(rec[0].shape[0], rec[3])


def pad_record(rec):
    """An `encode_record` result padded to its buckets, as numpy: (X [na,
    3], codes [na, V], residue codes [na], atom mask [na], n_res, nr), sink
    and padding rows code 0 as `BatchEncoder` fills them."""
    X, codes, rid, n_res = rec
    n = X.shape[0]
    na, nr = record_buckets(rec)
    Xp = np.zeros((na, 3), np.float32)
    qp = np.zeros((na, codes.shape[1]), np.int32)
    Mp = np.zeros((na,), np.int32)
    am = np.zeros((na,), np.float32)
    Xp[1 : n + 1], qp[1 : n + 1], Mp[1 : n + 1], am[1 : n + 1] = X, codes, rid, 1.0
    return Xp, qp, Mp, am, n_res, nr


def stack_batch(structures: list) -> PaddedStructure:
    """Stack same-bucket PaddedStructures into a batch (leading dim B):
    numpy when every field is numpy, torch tensors otherwise. y is stacked
    when every structure has it."""
    if not structures:
        raise ValueError("empty batch")
    shapes = {(tuple(s.X.shape), tuple(s.M.shape), tuple(s.res_mask.shape)) for s in structures}
    if len(shapes) != 1:
        raise ValueError(f"mixed bucket shapes in batch: {shapes}")
    fields = FIELDS if all(s.y is not None for s in structures) else FIELDS[:-1]
    all_np = all(isinstance(getattr(s, f), np.ndarray) for s in structures for f in fields)

    def stack(vals):
        if all_np:
            return np.stack(vals)
        dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
        return torch.stack([torch.as_tensor(v).to(dev) for v in vals])

    return PaddedStructure(**{f: stack([getattr(s, f) for s in structures]) for f in fields})


def to_device(ps: PaddedStructure, device) -> PaddedStructure:
    """A numpy (host) batch as tensors on `device`: to a card through pinned
    memory without waiting for the copy; integer fields stay int32."""
    dev = torch.device(device)

    def put(x):
        if x is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    return PaddedStructure(**{f: put(getattr(ps, f)) for f in FIELDS})


class BatchEncoder:
    """Reused batch buffers for the serving path (port of
    `pesto_tpu.batching.BatchEncoder`).

    Keeps batch-shaped host buffers per (B, na, nr, compact, q's row
    shape) signature (F features, or V vocabularies' codes),
    for the MAX_BATCH_SHAPES signatures used last, and has worker threads
    write each structure's rows in place. Consecutive encode() calls with
    one signature rotate through `n_sets` buffer sets, so a consumer that
    keeps `depth` earlier batches in flight needs n_sets >= depth + 1.
    For a card the buffers are pinned: encode(..., device=) copies the
    batch from them without waiting and records an event, and a set is
    refilled only once the copy out of it has run. On the CPU the tensors
    it returns alias the buffers. It fills no neighbour ids and no
    residue mask: a chunk computes its kNN on the device and takes nr from
    its bucket. Not safe for concurrent encode() calls on one instance; the
    fill of one call is threaded."""

    def __init__(self, num_threads: int = 8, n_sets: int = 2):
        self.n_sets = max(2, int(n_sets))
        self._sigs = collections.OrderedDict()  # signature -> {"sets", "turn"}, least recent first
        self._pool = ThreadPoolExecutor(num_threads)

    def close(self):
        self._pool.shutdown(wait=False)
        while self._sigs:
            self._drop(self._sigs.popitem(last=False)[1])

    @staticmethod
    def _drop(sig):
        for s in sig["sets"]:
            if s is not None and s["ready"] is not None:
                s["ready"].synchronize()

    @staticmethod
    def _alloc(key, pin):
        B, na, nr, compact, q_row = key
        # compact: integer codes, expanded on the device by the model
        shapes = dict(X=((B, na, 3), torch.float32),
                      q=((B, na, *q_row), torch.int32 if compact else torch.float32),
                      M=((B, na), torch.int32) if compact else ((B, na, nr), torch.float32),
                      am=((B, na), torch.float32))
        host = {k: torch.zeros(shape, dtype=dt, pin_memory=pin) for k, (shape, dt) in shapes.items()}
        return dict(host=host, np={k: t.numpy() for k, t in host.items()}, ready=None)

    def _get(self, key, pin):
        """The next buffer set of a signature, once the copy out of it has run."""
        sig = self._sigs.pop(key, None)
        if sig is None:
            while len(self._sigs) >= MAX_BATCH_SHAPES:
                self._drop(self._sigs.popitem(last=False)[1])
            sig = dict(sets=[None] * self.n_sets, turn=0)
        self._sigs[key] = sig
        k = sig["turn"] % self.n_sets
        sig["turn"] += 1
        if sig["sets"][k] is None:
            sig["sets"][k] = self._alloc(key, pin)
        s = sig["sets"][k]
        if s["ready"] is not None:
            with tracing.span("predict_batch.buffer_wait"):
                s["ready"].synchronize()
            s["ready"] = None
        return s

    def encode(self, items, na: int, nr: int, spatial_sort: bool = False,
               device=None) -> PaddedStructure:
        """items: unpadded structures, either dense 3-tuples (X [n,3],
        q [n,F] one-hot, M [n,r] one-hot) or compact 4-tuples (X [n,3],
        q_codes int [n, V] (a column per vocabulary, `encode_record`,
        `models.pesto.onehot_codes`) or [n] (one vocabulary), rid_codes
        [n] int, n_res).
        Returns the batch's X, q ([B, na, F] float32, or int32 [B, na, V] or
        [B, na]), M and atom_mask (no ids, no res_mask): numpy for
        device=None, else tensors on `device`. Sink and padding rows carry
        code 0 in compact q and M; the model masks them by atom_mask.

        spatial_sort=True Morton-sorts the atoms of each structure of more
        than NUM_NN atoms, as the JAX package's encoder does for its TPU
        gathers. The port keeps file order: the sort gains nothing on the
        card, and exact distance ties then go to the same neighbours as
        for the structure alone."""
        B = len(items)
        compact = len(items[0]) == 4
        dev = None if device is None else torch.device(device)
        slot = self._get((B, na, nr, compact, items[0][1].shape[1:]), pin=dev is not None and dev.type == "cuda")
        buf = slot["np"]

        def fill(j):
            if compact:
                X, q, M, r = items[j]
            else:
                X, q, M = items[j]
                r = M.shape[1]
            n = X.shape[0]
            if n + 1 > na or r > nr:
                raise ValueError(f"structure ({n},{r}) exceeds bucket ({na},{nr})")
            if spatial_sort and n > NUM_NN:
                # n <= k structures are not sort-invariant: a missing
                # neighbour's geometry wraps to the last real atom
                perm = morton_order(X)
                X, q, M = X[perm], q[perm], M[perm]
            for name, rows in (("X", X), ("q", q), ("M", M)):
                b = buf[name][j]
                b[0] = 0
                if name == "M" and not compact:
                    b[1 : n + 1, :r] = rows
                    b[1 : n + 1, r:] = 0
                else:
                    b[1 : n + 1] = rows
                b[n + 1 :] = 0
            buf["am"][j, 0] = 0
            buf["am"][j, 1 : n + 1] = 1.0
            buf["am"][j, n + 1 :] = 0

        list(self._pool.map(fill, range(B)))
        out = buf
        if dev is not None:
            out = {k: t.to(dev, non_blocking=True) for k, t in slot["host"].items()}
            if dev.type == "cuda":
                slot["ready"] = torch.cuda.Event()
                slot["ready"].record()
        return PaddedStructure(X=out["X"], ids_topk=None, q=out["q"], M=out["M"],
                               atom_mask=out["am"], res_mask=None)
