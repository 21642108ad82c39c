"""Inference: structure files -> per-residue interface probabilities.

Port of `pesto_tpu/infer.py`. One structure at a time
(`predict_structure`, `predict_pdb_file`): parse, clean and concatenate
on the host (numpy), pad into a bucket, then on the device the kNN
topology (one kernel launch), the forward (one edge-kernel launch per
layer) and the sigmoid. Batched (`predict_batch`, `predict_pdb_files`, the
server's path): records encode to integer codes (a column per feature
vocabulary, the residue codes) in a thread pool, group by
bucket into chunks under an atom budget, and each chunk runs the batched
kNN (one launch), the forward over the flattened batch (one edge launch
per layer) and the sigmoid, with up to `pipeline_depth` chunks in flight
on the device while the host encodes the next one. Pairs of structures
(`predict_pairs`, a Predictor of the dimer model) take the same stages:
each chunk holds pairs of one key of both sides' buckets, runs the kNN of
each side and the dimer's forward over both sides' rows (one edge and one
cross-attention launch per layer).

Several devices, from this one process (`parallel.mesh.make_mesh`):
`Predictor(mesh=)` serves data-parallel, each chunk split across the
mesh's data axis, each device running its part alone with no collective;
`predict_structure_sp(structure, mesh)` runs one structure with its atoms
sharded over the mesh's model axis (`parallel.sp`).
"""

import contextlib
import dataclasses
import io
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from . import batching
from .batching import BatchEncoder, PaddedStructure, encode_and_pad, pick_bucket, to_device
from .device import resolve_device
from .encoding import std_elements, std_names, std_resnames, vocab_codes
from .io import read_structure
from .models import CrossPestoModel, PestoConfig, PestoModel
from .ops import cross_attention as _cross
from .ops import edge_attention as _edge
from .ops import knn as _knn
from .ops.knn import knn_ids
from .parallel.mesh import batch_sharding, canonical, replicate, replicated_sharding
from .parallel.sp import ShardedForward
from .port import load_reference_checkpoint
from .structure import concatenate_chains, preprocess_structure
from .utils import tracing

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Predictor:
    """A PestoModel with its weights on one device, or on each device of a
    mesh; or, given a dimer's state dict, a CrossPestoModel on one device,
    which answers `predict_pairs`.

    device=None means the GPU, and raises where there is none; pass
    device="cpu" for the plain PyTorch versions of the kernels. With a
    `mesh` (`parallel.make_mesh`), the model is replicated on each of its
    distinct devices, the first of them is `device`, and predict_batch
    splits each chunk across the data axis. The topology is always the
    exact kNN. predict_batch may run from several threads at once: each
    call checks a private BatchEncoder out of an idle pool, which keeps at
    most ENC_POOL_IDLE of them (one per batcher thread of the server), and
    the stage timers have their own lock."""

    ENC_POOL_IDLE = 2

    def __init__(self, cfg: PestoConfig, state_dict, device=None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self._data_devices = [canonical(resolve_device(d)) for d in batch_sharding(mesh)]
            device = self._data_devices[0] if device is None else device
        self.device = resolve_device(device)
        self.cfg = cfg
        # a dimer's state dict (its layers are `csul.{i}`) makes a
        # CrossPestoModel, which answers predict_pairs
        self.dimer = any(k.startswith("csul.") for k in state_dict)
        if self.dimer and mesh is not None:
            raise ValueError("a dimer Predictor runs on one device, not over a mesh")
        model = (CrossPestoModel if self.dimer else PestoModel)(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=_DTYPES[cfg.dtype]).eval()
        if mesh is not None:
            # the weights on every device of the mesh, as JAX replicates
            # its params; a chunk's part runs by the replica where its rows are
            self._replicas = replicate(self.model, replicated_sharding(mesh))
        self._sp_cache = {}  # mesh content -> ShardedForward
        self._sp_lock = threading.Lock()
        # cumulative host ms inside predict_batch and its calls: the
        # always-on totals of its spans predict_batch.record_encode (the
        # record encode pool), .batch_encode (the batch encode and copy) and
        # .collect (the blocked readback); the stages overlap under the
        # pipeline, so they attribute time rather than add up to it
        self._stages = tracing.Sums({"record_encode": 0.0, "batch_encode": 0.0,
                                     "device_wait": 0.0, "batch_calls": 0})
        self.stage_ms = self._stages.ms
        self._stage_lock = self._stages.lock
        # idle encoders, at most ENC_POOL_IDLE: a burst of concurrent callers
        # closes the encoders past it when they return
        self._enc_pool: "queue.Queue[BatchEncoder]" = queue.Queue(maxsize=self.ENC_POOL_IDLE)

    @classmethod
    def from_reference_checkpoint(cls, path: str, cfg: PestoConfig = None, **kw) -> "Predictor":
        """cfg=None infers the variant from the checkpoint's tensor shapes."""
        if cfg is None:
            sd, cfg = load_reference_checkpoint(path)
            return cls(cfg, sd, **kw)
        return cls(cfg, load_reference_checkpoint(path, cfg), **kw)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def logits(self, ps: PaddedStructure) -> torch.Tensor:
        """Per-residue logits [NR, C] (or [B, NR, C] for a batch), on the
        device. Integer (compact) M takes nr from res_mask's width."""
        M = self._tensor(ps.M)
        nr = int(np.shape(ps.res_mask)[-1]) if not torch.is_floating_point(M) else None
        return self.model(
            self._tensor(ps.X, torch.float32), self._tensor(ps.ids_topk),
            self._tensor(ps.q), M, self._tensor(ps.atom_mask, torch.float32), nr=nr,
        )

    def probabilities(self, ps: PaddedStructure) -> np.ndarray:
        """sigmoid(logits) as float32 numpy."""
        return torch.sigmoid(self.logits(ps).to(torch.float32)).cpu().numpy()

    def predict_structure(self, structure: dict) -> np.ndarray:
        """Cleaned and concatenated structure record -> [n_res, C] probs."""
        ps = encode_and_pad(structure, feature_flags=self.cfg.feature_flags,
                            device=self.device)
        nr = int(np.sum(ps.res_mask))
        return self.probabilities(ps)[:nr]

    def export_compiled(self, path: str, buckets=((512, 64),)) -> None:
        """Save the forward as `torch.export` programs, one per (na, nr)
        bucket, for deployment without the model's Python code (the JAX
        package's `export_compiled`, pesto_tpu/infer.py:169-205). Each
        program holds this Predictor's weights on its device and takes
        dense padded inputs (X, ids, q, M, atom_mask) of its bucket; every
        layer's edge attention is one `pesto_tpu_torch::edge_attention`
        node. Load with `Predictor.load_exported`."""
        from .synthetic import random_padded_structure

        blobs = {}
        for na, nr in buckets:
            ps = random_padded_structure(
                n_atoms=min(na - 1, 64), n_res=min(nr, 8), n_features=self.cfg.em_n0,
                na=na, nr=nr, device=self.device,
            )
            args = (self._tensor(ps.X, torch.float32), self._tensor(ps.ids_topk),
                    self._tensor(ps.q), self._tensor(ps.M), self._tensor(ps.atom_mask, torch.float32))
            with torch.no_grad():
                program = torch.export.export(self.model, args)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            blobs[f"{na},{nr}"] = torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)
        torch.save(blobs, path)

    @staticmethod
    def load_exported(path: str) -> dict:
        """Programs saved by `export_compiled`: {(na, nr): callable(X, ids,
        q, M, atom_mask) -> logits [nr, C]}, on the device they were
        exported on. (JAX's callables take the parameters first; these
        carry their weights.)"""
        from .ops import edge_attention  # noqa: F401 — registers the operator the programs call

        blobs = torch.load(path, map_location="cpu", weights_only=True)
        out = {}
        for key, blob in blobs.items():
            na, nr = (int(v) for v in key.split(","))
            out[(na, nr)] = torch.export.load(io.BytesIO(blob.numpy().tobytes())).module()
        return out

    def predict_structure_sp(self, structure: dict, mesh) -> np.ndarray:
        """Cleaned and concatenated structure record -> [n_res, C] probs,
        with the structure's atoms sharded over the mesh's model axis
        (`parallel.sp`): for structures whose forward does not fit one
        device, in any atom bucket up to the largest. The kNN runs once, on
        the first device, over the whole structure; the forward then runs
        sharded. Integer codes, so the host arrays stay O(atoms)."""
        Xp, qp, Mp, am, n_res, nr = self._pad_record(self._encode_record(structure))
        # cached by the mesh's devices, not its identity: a caller that
        # makes an equal mesh per call reuses the replicas
        with self._sp_lock:
            fwd = self._sp_cache.get(mesh.key())
            if fwd is None:
                fwd = self._sp_cache[mesh.key()] = ShardedForward(self.model, mesh.model_devices())
        first = fwd.devices[0]
        with torch.no_grad():
            Xt = torch.as_tensor(Xp).to(first)
            amt = torch.as_tensor(am).to(first)
            ids, _ = knn_ids(Xt[None], amt[None])
            z = fwd(Xt, ids[0], torch.as_tensor(qp), torch.as_tensor(Mp), amt, nr=nr)
            probs = torch.sigmoid(z.to(torch.float32)).cpu().numpy()
        return probs[:n_res]

    def predict_pdb_file(self, path: str) -> Tuple[dict, np.ndarray]:
        """PDB or mmCIF file -> (preprocessed merged structure, [n_res, C]
        probs): read -> clean -> tag -> split -> filter -> dedup -> concat
        -> model, the reference inference chain."""
        structure = concatenate_chains(preprocess_structure(read_structure(path)))
        return structure, self.predict_structure(structure)

    # -- batched inference ------------------------------------------------

    @torch.no_grad()
    def _knn_forward_sigmoid(self, X, q, M, am, nr=None) -> torch.Tensor:
        """One chunk on the device: the batched kNN, the forward over the
        flattened batch (by the replica on X's device, over a mesh) and an
        fp32 sigmoid. X [B, NA, 3], am [B, NA] float32; q and M dense or
        integer codes (then nr is required). Returns probabilities
        [B, NR, C] without a host sync."""
        ids, _ = knn_ids(X, am)
        model = self.model if self.mesh is None else self._replicas[canonical(X.device)]
        return torch.sigmoid(model(X, ids, q, M, am, nr=nr).to(torch.float32))

    def _compact_spec(self):
        """[(vocabulary, record field, offset)] of each feature vocabulary
        that the config's flags set, in the one-hot's order (elements,
        residue names, atom names): the offset is the vocabulary's first
        column of the concatenated one-hot, whose "other" column follows
        each vocabulary. ValueError when em_n0 is not their total width."""
        spec, offset = [], 0
        for flag, vocab, field in zip(self.cfg.feature_flags, (std_elements, std_resnames, std_names),
                                      ("element", "resname", "name")):
            if flag:
                spec.append((vocab, field, offset))
                offset += len(vocab) + 1
        if self.cfg.em_n0 != offset:
            raise ValueError(f"integer codes of the flagged vocabularies need em_n0 == {offset}, "
                             f"got {self.cfg.em_n0}")
        return spec

    def _encode_record(self, s):
        """Structure record -> host arrays (X [n, 3] float32, codes [n, V]
        int32: a column per vocabulary, offset into the one-hot's columns,
        residue codes [n] int32, n_res); the device expands both codes
        (`models.pesto.onehot_codes`)."""
        X = np.asarray(s["xyz"], dtype=np.float32)
        spec = self._compact_spec()
        codes = np.empty((X.shape[0], len(spec)), np.int32)
        for k, (vocab, field, offset) in enumerate(spec):
            codes[:, k] = vocab_codes(s[field], vocab) + offset
        _, rid = np.unique(np.asarray(s["resid"]), return_inverse=True)
        return X, codes, rid.astype(np.int32), int(rid.max()) + 1

    @staticmethod
    def _pad_record(rec):
        """An encoded record padded to its buckets, as numpy: (X [na, 3],
        codes [na, V], residue codes [na], atom mask [na], n_res, nr), sink
        and padding rows code 0 as the BatchEncoder fills them."""
        X, codes, rid, n_res = rec
        n = X.shape[0]
        na = pick_bucket(n + 1, batching.ATOM_BUCKETS)
        nr = pick_bucket(max(n_res, 1), batching.RES_BUCKETS)
        Xp = np.zeros((na, 3), np.float32)
        qp = np.zeros((na, codes.shape[1]), np.int32)
        Mp = np.zeros((na,), np.int32)
        am = np.zeros((na,), np.float32)
        Xp[1 : n + 1], qp[1 : n + 1], Mp[1 : n + 1], am[1 : n + 1] = X, codes, rid, 1.0
        return Xp, qp, Mp, am, n_res, nr

    def warmup(self, buckets=None, batch_sizes=(1,)) -> None:
        """Build the CUDA libraries (on a card) and run one chunk per
        (na, nr) bucket and batch size, so that a server's first requests
        pay neither the build nor the first allocations. buckets=None means
        every atom bucket up to 32768, each with the residue bucket real
        proteins reach (~8 atoms per residue)."""
        from .ops import _build
        from .synthetic import random_structure_arrays

        if self.device.type == "cuda":
            _build.build_all(("knn", "edge_attention"))
        if buckets is None:
            buckets = [(na, pick_bucket(max(na // 8, batching.RES_BUCKETS[0]), batching.RES_BUCKETS))
                       for na in batching.ATOM_BUCKETS if na <= 32768]
        n_vocab = len(self._compact_spec())
        replicas = self._replicas if self.mesh is not None else {self.device: self.model}
        for na, nr in buckets:
            X, q, M = random_structure_arrays(n_atoms=min(na - 1, 64), n_res=min(nr, 8),
                                              n_features=self.cfg.em_n0)
            ps = batching.pad_structure_arrays(X, q, M, na=na, nr=nr)
            for b in batch_sizes:
                for dev in replicas:
                    batch = to_device(dataclasses.replace(batching.stack_batch([ps] * b), ids_topk=None),
                                      dev)
                    # the [b, na, V] feature codes and [b, na] residue codes of predict_batch
                    codes = torch.zeros((b, na, n_vocab), dtype=torch.int32, device=dev)
                    rid = torch.zeros((b, na), dtype=torch.int32, device=dev)
                    self._knn_forward_sigmoid(batch.X, codes, rid, batch.atom_mask, nr=nr).cpu()

    @contextlib.contextmanager
    def _encoder(self, num_threads, need_sets):
        """A BatchEncoder with at least `need_sets` buffer sets, checked out
        of the idle pool (or made) for one call and put back after it."""
        try:
            enc = self._enc_pool.get_nowait()
        except queue.Empty:
            enc = None
        if enc is not None and enc.n_sets < need_sets:
            enc.close()
            enc = None
        if enc is None:
            enc = BatchEncoder(num_threads, n_sets=need_sets)
        try:
            yield enc
        finally:
            try:
                self._enc_pool.put_nowait(enc)
            except queue.Full:
                enc.close()

    def _encode_records(self, call_name, records, num_threads, cid):
        """The `<call_name>.record_encode` stage: each record to host arrays
        in a thread pool (`_encode_record`), None and a line on stderr for
        one that fails."""

        def encode_record(arg):
            i, s = arg
            with tracing.span(f"{call_name}.encode_record", parent=record_stage, call=cid, structure=i):
                try:
                    return self._encode_record(s)
                except Exception as e:  # noqa: BLE001 — one bad record gives None
                    print(f"EncodeError: structure {i}: {type(e).__name__}: {e}", file=sys.stderr)
                    return None

        with tracing.span(f"{call_name}.record_encode", sums=self._stages, key="record_encode",
                          call=cid) as record_stage:
            with ThreadPoolExecutor(max(1, int(num_threads))) as pool:
                recs = list(pool.map(encode_record, enumerate(records)))
        self._stages.count("batch_calls")
        return recs

    @staticmethod
    def _bucket(rec):
        """(atom bucket, residue bucket) of an encoded record; ValueError
        past the largest."""
        return (pick_bucket(rec[0].shape[0] + 1, batching.ATOM_BUCKETS),
                pick_bucket(max(rec[3], 1), batching.RES_BUCKETS))

    @staticmethod
    def _to_host(*probs):
        """The probabilities copied to pinned host memory without waiting,
        and the event after the copies: (host tensors, event), the event
        None off a card."""
        if not probs[0].is_cuda:
            return probs, None
        hosts = []
        for t in probs:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ready = torch.cuda.Event()
        ready.record()
        return tuple(hosts), ready

    @staticmethod
    def _pipeline(chunks, submit, collect, pipeline_depth) -> None:
        """submit(chunk) for each chunk in turn, with at most
        `pipeline_depth` submitted chunks not yet collected; collect(chunk,
        submit's result) in the same order."""
        depth = max(1, int(pipeline_depth))
        pending = deque()
        for chunk in chunks:
            pending.append((chunk, submit(chunk)))
            if len(pending) > depth:
                collect(*pending.popleft())
        while pending:
            collect(*pending.popleft())

    def predict_batch(self, structures: list, atoms_per_call: int = 32768,
                      num_threads: int = 8, pipeline_depth: int = 2) -> list:
        """Cleaned structure records -> list of [n_res_i, C] probabilities,
        grouped by bucket into chunks of at most `atoms_per_call` padded
        atoms (at least one structure). A record that cannot be encoded
        (EncodeError) or is over the largest bucket (SizeError) gives None
        and a line on stderr; it never fails the others. Up to
        `pipeline_depth` chunks stay in flight on the device while the host
        encodes the next one and reads back the oldest. While spans are
        recorded (`utils.tracing`), the call is a `predict_batch` span whose
        stages are its children, each with the call's id."""
        if self.dimer:
            raise TypeError("a dimer Predictor answers predict_pairs, not predict_batch")
        ndev = len(self._data_devices) if self.mesh is not None else 1
        need_sets = max(2, (int(pipeline_depth) + 1) * ndev)
        # grad mode is per thread
        with self._encoder(num_threads, need_sets) as enc, torch.no_grad(), \
                tracing.span("predict_batch", structures=len(structures)) as call:
            return self._predict_batch_impl(structures, atoms_per_call, num_threads,
                                            pipeline_depth, call, enc)

    def _predict_batch_impl(self, structures, atoms_per_call, num_threads, pipeline_depth, call, encoder):
        cid = call.span_id if call is not None else None
        recs = self._encode_records("predict_batch", structures, num_threads, cid)

        buckets = {}
        with tracing.span("predict_batch.plan", call=cid):
            for i, rec in enumerate(recs):
                if rec is None:
                    continue
                try:
                    key = self._bucket(rec)
                except ValueError as e:
                    print(f"SizeError: structure {i}: {e}", file=sys.stderr)
                    continue
                buckets.setdefault(key, []).append(i)
        out = [None] * len(structures)

        devices = self._data_devices if self.mesh is not None else [self.device]
        ndev = len(devices)

        def submit_part(part, na, nr, dev):
            """Encode and launch one chunk's part on `dev`; the probabilities
            come back to pinned host memory asynchronously, behind an
            event. Its spans' attributes: the bucket, B, the real and padded
            atoms, the feature codes' columns (`codes`: V) and the bytes
            copied to the card; the kNN and edge launches."""
            with tracing.span("predict_batch.batch_encode", sums=self._stages, key="batch_encode",
                              call=cid) as sp:
                # on a card a copy out of the encoder's pinned buffers, which
                # the encoder refills only after the copy's event
                b = encoder.encode([recs[i] for i in part], na=na, nr=nr, device=dev)
                if sp is not None:
                    sent = (b.X, b.q, b.M, b.atom_mask) if b.X.is_cuda else ()
                    sp.attrs.update(na=na, nr=nr, B=len(part), padded_atoms=len(part) * na,
                                    real_atoms=sum(int(recs[i][0].shape[0]) for i in part),
                                    codes=int(b.q.shape[-1]), h2d_bytes=sum(t.nbytes for t in sent))
            with tracing.span("predict_batch.launch", call=cid) as sp:
                if sp is not None:
                    knn0, edge0 = _knn.knn_kernel.launches, _edge.edge_attention_kernel.launches
                probs = self._knn_forward_sigmoid(b.X, b.q, b.M, b.atom_mask, nr=nr)
                (host,), ready = self._to_host(probs)
                if sp is not None:
                    sp.attrs.update(knn_launches=_knn.knn_kernel.launches - knn0,
                                    edge_launches=_edge.edge_attention_kernel.launches - edge0)
            return host, ready

        def submit(chunk):
            """One chunk, as len(devices) equal parts, each on its device
            with no exchange between them. Over a mesh, a chunk is padded to
            a multiple of the devices by repeating its first structure,
            whose copies are never collected."""
            group, na, nr = chunk
            dispatch = group + [group[0]] * (-len(group) % ndev)
            per = len(dispatch) // len(devices)
            results = []
            for k, dev in enumerate(devices):
                part = dispatch[k * per : (k + 1) * per]
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results.append(submit_part(part, na, nr, dev))
                else:
                    results.append(submit_part(part, na, nr, dev))
            return results

        def collect(chunk, results):
            with tracing.span("predict_batch.collect", sums=self._stages, key="device_wait", call=cid):
                for _, ready in results:
                    if ready is not None:
                        ready.synchronize()
                probs = np.concatenate([host.numpy() for host, _ in results])
            for j, i in enumerate(chunk[0]):
                out[i] = probs[j, : recs[i][3]]

        chunks = []
        for (na, nr), group in buckets.items():
            # an atom budget per device
            bmax = max(ndev, atoms_per_call * ndev // na)
            bmax -= bmax % ndev
            chunks += [(group[k : k + bmax], na, nr) for k in range(0, len(group), bmax)]
        self._pipeline(chunks, submit, collect, pipeline_depth)
        return out

    @torch.no_grad()
    def _pair_forward_sigmoid(self, ba, bb, nr_a=None, nr_b=None):
        """One chunk of pairs on the device: the batched kNN of each side,
        the dimer's forward over both sides' rows and an fp32 sigmoid.
        Returns probabilities ([B, NRa, C], [B, NRb, C]) without a host
        sync."""
        ids_a, _ = knn_ids(ba.X, ba.atom_mask)
        ids_b, _ = knn_ids(bb.X, bb.atom_mask)
        za, zb = self.model((ba.X, ids_a, ba.q, ba.M, ba.atom_mask), (bb.X, ids_b, bb.q, bb.M, bb.atom_mask),
                            nr_a=nr_a, nr_b=nr_b)
        return torch.sigmoid(za.to(torch.float32)), torch.sigmoid(zb.to(torch.float32))

    def predict_pairs(self, pairs: list, atoms_per_call: int = 32768, num_threads: int = 8,
                      pipeline_depth: int = 2) -> list:
        """Pairs of cleaned structure records [(a, b)] -> [(probs_a [n_res_a,
        C], probs_b [n_res_b, C])], each side conditioned on the other, in
        the caller's order; needs a dimer Predictor. The stages are
        predict_batch's: each distinct record (by identity) of the call is
        encoded once, in the thread pool; each pair is keyed by its sides'
        (atom, residue) buckets, its larger side first (the answer mapped
        back), and the pairs of a key go in chunks of at most
        `atoms_per_call` padded atoms a side; a chunk's two sides go through
        the BatchEncoder and the kNN kernel, the forward runs both sides'
        rows as one table (one edge and one cross-attention launch a
        layer), and up to `pipeline_depth` chunks stay in flight. A pair
        with a record that cannot be encoded or is over the largest bucket
        gives None (a line on stderr); the other pairs are answered. While
        spans are recorded, the call is a `predict_pairs` span with the
        stages of predict_batch's under the same names."""
        if not self.dimer:
            raise TypeError("predict_pairs needs a dimer Predictor (a CrossPestoModel state dict)")
        need_sets = max(2, 2 * (int(pipeline_depth) + 1))  # two encodes a chunk, maybe of one shape
        with self._encoder(num_threads, need_sets) as enc, torch.no_grad(), \
                tracing.span("predict_pairs", pairs=len(pairs)) as call:
            return self._predict_pairs_impl(pairs, atoms_per_call, num_threads, pipeline_depth, call, enc)

    def _predict_pairs_impl(self, pairs, atoms_per_call, num_threads, pipeline_depth, call, encoder):
        cid = call.span_id if call is not None else None
        index, distinct = {}, []
        for pair in pairs:
            for s in pair:
                if id(s) not in index:
                    index[id(s)] = len(distinct)
                    distinct.append(s)
        recs = self._encode_records("predict_pairs", distinct, num_threads, cid)

        groups = {}
        with tracing.span("predict_pairs.plan", call=cid):
            for i, (a, b) in enumerate(pairs):
                sa, sb = index[id(a)], index[id(b)]
                if recs[sa] is None or recs[sb] is None:
                    continue
                swap = recs[sb][0].shape[0] > recs[sa][0].shape[0]
                if swap:
                    sa, sb = sb, sa
                try:
                    key = self._bucket(recs[sa]) + self._bucket(recs[sb])
                except ValueError as e:
                    print(f"SizeError: pair {i}: {e}", file=sys.stderr)
                    continue
                groups.setdefault(key, []).append((i, sa, sb, swap))
        out = [None] * len(pairs)
        dev = self.device

        def submit(chunk):
            """Encode and launch one chunk of pairs; its spans' attributes:
            both sides' buckets, B, the real and padded atoms of both sides,
            the real pairs' sum of n_a * n_b, the feature codes' columns, the
            bytes copied to the card, and the kNN, edge and cross-attention
            launches."""
            group, na_a, nr_a, na_b, nr_b = chunk
            with tracing.span("predict_pairs.batch_encode", sums=self._stages, key="batch_encode",
                              call=cid) as sp:
                side_a, side_b = [recs[x[1]] for x in group], [recs[x[2]] for x in group]
                ba = encoder.encode(side_a, na=na_a, nr=nr_a, device=dev)
                bb = encoder.encode(side_b, na=na_b, nr=nr_b, device=dev)
                if sp is not None:
                    n_a = [int(r[0].shape[0]) for r in side_a]
                    n_b = [int(r[0].shape[0]) for r in side_b]
                    sent = (ba.X, ba.q, ba.M, ba.atom_mask, bb.X, bb.q, bb.M, bb.atom_mask) if ba.X.is_cuda else ()
                    sp.attrs.update(na_a=na_a, na_b=na_b, nr_a=nr_a, nr_b=nr_b, B=len(group),
                                    real_atoms=sum(n_a) + sum(n_b), padded_atoms=len(group) * (na_a + na_b),
                                    real_pairs=sum(x * y for x, y in zip(n_a, n_b)), codes=int(ba.q.shape[-1]),
                                    h2d_bytes=sum(t.nbytes for t in sent))
            with tracing.span("predict_pairs.launch", call=cid) as sp:
                if sp is not None:
                    before = (_knn.knn_kernel.launches, _edge.edge_attention_kernel.launches,
                              _cross.cross_attention_kernel.launches)
                probs = self._pair_forward_sigmoid(ba, bb, nr_a, nr_b)
                result = self._to_host(*probs)
                if sp is not None:
                    after = (_knn.knn_kernel.launches, _edge.edge_attention_kernel.launches,
                             _cross.cross_attention_kernel.launches)
                    sp.attrs.update(zip(("knn_launches", "edge_launches", "cross_launches"),
                                        (y - x for x, y in zip(before, after))))
            return result

        def collect(chunk, result):
            (host_a, host_b), ready = result
            with tracing.span("predict_pairs.collect", sums=self._stages, key="device_wait", call=cid):
                if ready is not None:
                    ready.synchronize()
                pa, pb = host_a.numpy().copy(), host_b.numpy().copy()
            for j, (i, sa, sb, swap) in enumerate(chunk[0]):
                a, b = pa[j, : recs[sa][3]], pb[j, : recs[sb][3]]
                out[i] = (b, a) if swap else (a, b)

        chunks = []
        for key, group in groups.items():
            bmax = max(1, atoms_per_call // max(key[0], key[2]))  # the budget binds each side
            chunks += [(group[k : k + bmax], *key) for k in range(0, len(group), bmax)]
        self._pipeline(chunks, submit, collect, pipeline_depth)
        return out

    def predict_pdb_files(self, paths: list, num_threads: int = 8, atoms_per_call: int = 32768,
                          pipeline_depth: int = 2) -> Tuple[list, list]:
        """PDB/mmCIF paths -> (structures, probs), aligned with `paths`.
        The files are read and cleaned in a thread pool, then predicted by
        predict_batch. A file that cannot be read gives (None, None) and a
        ReadError on stderr; a structure that cannot be predicted gives
        (structure, None)."""

        def load(path):
            try:
                return concatenate_chains(preprocess_structure(read_structure(path)))
            except Exception as e:  # noqa: BLE001 — one bad file gives None
                print(f"ReadError: {path}: {e}", file=sys.stderr)
                return None

        with ThreadPoolExecutor(max(1, int(num_threads))) as pool:
            structures = list(pool.map(load, paths))
        keep = [s for s in structures if s is not None]
        kept = (self.predict_batch(keep, atoms_per_call=atoms_per_call,
                                   pipeline_depth=pipeline_depth) if keep else [])
        it = iter(kept)
        return structures, [next(it) if s is not None else None for s in structures]
