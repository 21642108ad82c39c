"""Inference: structure files -> per-residue interface probabilities.

Port of `pesto_tpu/infer.py`. Records encode to integer codes (a column
per feature vocabulary, the residue codes: `batching.encode_record`). One
structure at a time (`predict_structure`, `predict_pdb_file`): parse,
clean and concatenate on the host (numpy), pad the codes into a bucket,
then on the device the kNN topology (one kernel launch), the forward (one
edge-kernel launch per layer) and the sigmoid. Batched (`predict_batch`,
`predict_pdb_files`, the server's path) and pairs of structures
(`predict_pairs`, a Predictor of the dimer model) share one scheduler
(`_schedule`): the items (a record, or a pair's two) group by their
sides' buckets, known from each record's sizes, into chunks under an atom
budget; each chunk's records are encoded as it is submitted, on the
caller's thread, and the chunk runs the batched kNN of each side (one
launch a side), the forward over the flattened batch (one edge launch per
layer, and for the dimer one cross-attention launch) and the sigmoid, with
up to `pipeline_depth` chunks in flight on the device while the host
encodes the next one.

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
from .batching import BatchEncoder, PaddedStructure, pick_bucket, to_device
from .device import resolve_device
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
        # records' sizes, then each chunk's record codes), .batch_encode
        # (the batch encode and copy) and .collect (the blocked readback);
        # the stages overlap under the pipeline, so they attribute time
        # rather than add up to it
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

    @torch.no_grad()
    def predict_structure(self, structure: dict) -> np.ndarray:
        """Cleaned and concatenated structure record -> [n_res, C] probs:
        its integer codes padded to its buckets (`batching.pad_record`), the
        kNN, the forward and the sigmoid on the device."""
        Xp, qp, Mp, am, n_res, nr = batching.pad_record(batching.encode_record(structure, self.cfg))
        X, am = self._tensor(Xp), self._tensor(am)
        ids, _ = knn_ids(X[None], am[None])
        z = self.model(X, ids[0], self._tensor(qp), self._tensor(Mp), am, nr=nr)
        return torch.sigmoid(z.to(torch.float32)).cpu().numpy()[:n_res]

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
        Xp, qp, Mp, am, n_res, nr = batching.pad_record(batching.encode_record(structure, self.cfg))
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
    def _forward(self, *sides) -> tuple:
        """One chunk on the device: the batched kNN of each side, the
        model's forward over the flattened batch and an fp32 sigmoid. A side
        is (X [B, NA, 3], q, M, atom_mask [B, NA] float32, nr), q and M dense
        or integer codes (then nr is required): one side for a PestoModel,
        run by the replica on X's device over a mesh; the two sides of a
        batch of pairs for the dimer, both sides' rows in one table.
        Returns each side's probabilities [B, NR, C] without a host sync."""
        inputs = [((X, knn_ids(X, am)[0], q, M, am), nr) for X, q, M, am, nr in sides]
        if self.dimer:
            (A, nr_a), (B, nr_b) = inputs
            z = self.model(A, B, nr_a=nr_a, nr_b=nr_b)
        else:
            ((X, *rest), nr), = inputs
            model = self.model if self.mesh is None else self._replicas[canonical(X.device)]
            z = (model(X, *rest, nr=nr),)
        return tuple(torch.sigmoid(t.to(torch.float32)) for t in z)

    def _launches(self) -> dict:
        """The launch counters that a chunk's `.launch` span diffs: the
        kNN and edge kernels, and the dimer's cross attention."""
        n = {"knn_launches": _knn.knn_kernel.launches, "edge_launches": _edge.edge_attention_kernel.launches}
        if self.dimer:
            n["cross_launches"] = _cross.cross_attention_kernel.launches
        return n

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
        n_vocab = len(batching.compact_spec(self.cfg))
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
                    self._forward((batch.X, codes, rid, batch.atom_mask, nr))[0].cpu()

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
        """submit(chunk, in_flight) for each chunk in turn, in_flight the
        chunks submitted and not yet collected (at most `pipeline_depth`);
        collect(*submit's result) in the same order. A submit that returns
        None launched nothing, and nothing of it is collected."""
        depth = max(1, int(pipeline_depth))
        pending = deque()
        for chunk in chunks:
            submitted = submit(chunk, len(pending))
            if submitted is not None:
                pending.append(submitted)
            if len(pending) > depth:
                collect(*pending.popleft())
        while pending:
            collect(*pending.popleft())

    def _schedule(self, call_name, records, n_out, plan, n_sides, atoms_per_call, num_threads,
                  pipeline_depth, **call_attrs) -> list:
        """The stages of the batched call `call_name` over `records`, under
        its span (whose attributes are `call_attrs`), all of the record work
        on the caller's thread. First the sizes of every record
        (`batching.record_sizes`); `plan(sizes)` then yields (slot, name,
        item): an item is a tuple of `n_sides` record indices, one per side
        of `_forward`, its answer goes to out[slot], and a SizeError names
        it. Items are keyed by their sides' (atom, residue) buckets, and the
        items of a key, in first-seen order, go in chunks of at most
        `atoms_per_call` padded atoms a side (at least one item); over a
        mesh, per device, and a chunk splits into equal parts, one per data
        device. As each chunk is submitted, the coordinates and vocabulary
        codes (`batching.record_codes`) of its records not yet coded are
        made, while up to `pipeline_depth` earlier chunks run on the card;
        an item with a record whose codes fail leaves its chunk. Each
        part's sides then go through the BatchEncoder and `_forward`, the
        probabilities back to pinned host memory. Returns out [n_out]: each
        slot's (item, its sides' probabilities [n_res, C] in the item's
        order), or None. A record that fails its sizes or its codes gives
        an EncodeError line on stderr; each record is coded at most once a
        call, and nothing is kept after it."""
        devices = self._data_devices if self.mesh is not None else [self.device]
        ndev = len(devices)
        # an encode a side of each part of each chunk in flight and the next
        need_sets = max(2, (int(pipeline_depth) + 1) * ndev * n_sides)
        # grad mode is per thread
        with self._encoder(num_threads, need_sets) as encoder, torch.no_grad(), \
                tracing.span(call_name, **call_attrs) as call:
            cid = call.span_id if call is not None else None

            def encoded(i, part, *args):
                """part(records[i], *args), or None and a line on stderr."""
                try:
                    return part(records[i], *args)
                except Exception as e:  # noqa: BLE001 — one bad record gives None
                    print(f"EncodeError: structure {i}: {type(e).__name__}: {e}", file=sys.stderr)
                    return None

            with tracing.span(f"{call_name}.record_encode", sums=self._stages, key="record_encode",
                              call=cid, records=len(records), in_flight=0):
                sizes = [encoded(i, batching.record_sizes) for i in range(len(records))]
            self._stages.count("batch_calls")
            groups = {}
            with tracing.span(f"{call_name}.plan", call=cid):
                for slot, name, item in plan(sizes):
                    try:
                        key = tuple(batching.size_buckets(sizes[r][0], sizes[r][2]) for r in item)
                    except ValueError as e:
                        print(f"SizeError: {name}: {e}", file=sys.stderr)
                        continue
                    groups.setdefault(key, []).append((slot, item))
            out = [None] * n_out
            side_names = [""] if n_sides == 1 else ["_a", "_b"]  # na, nr or na_a, nr_a, na_b, nr_b
            coded = {}  # record index -> (X, codes), or None where they failed

            def code_records(group, in_flight):
                """The chunk's `.record_encode` stage: the codes of its
                records not coded yet, each under an `.encode_record` span.
                Returns the items whose records all have their codes."""
                todo = [r for r in dict.fromkeys(r for _, item in group for r in item) if r not in coded]
                with tracing.span(f"{call_name}.record_encode", sums=self._stages, key="record_encode",
                                  call=cid, records=len(todo), in_flight=in_flight):
                    for r in todo:
                        with tracing.span(f"{call_name}.encode_record", call=cid, structure=r):
                            coded[r] = encoded(r, batching.record_codes, self.cfg)
                return [(slot, item) for slot, item in group if all(coded[r] is not None for r in item)]

            def submit_part(part, key, dev):
                """Encode and launch one chunk's part on `dev`; the
                probabilities come back to pinned host memory
                asynchronously, behind an event. Its spans' attributes: each
                side's buckets, B, the real and padded atoms of all sides,
                for pairs the real pairs' sum of n_a * n_b, the feature
                codes' columns (`codes`: V), the bytes copied to the card;
                the launches of `_launches`."""
                with tracing.span(f"{call_name}.batch_encode", sums=self._stages, key="batch_encode",
                                  call=cid) as sp:
                    # on a card a copy out of the encoder's pinned buffers,
                    # which the encoder refills only after the copy's event
                    sides = []
                    for k, (na, nr) in enumerate(key):
                        b = encoder.encode([coded[item[k]] + sizes[item[k]][1:] for _, item in part],
                                           na=na, nr=nr, device=dev)
                        sides.append((b.X, b.q, b.M, b.atom_mask, nr))
                    if sp is not None:
                        n = [[sizes[item[k]][0] for _, item in part] for k in range(n_sides)]
                        for x, (na, nr) in zip(side_names, key):
                            sp.attrs.update({f"na{x}": na, f"nr{x}": nr})
                        sp.attrs.update(B=len(part), real_atoms=sum(map(sum, n)),
                                        padded_atoms=len(part) * sum(na for na, _ in key))
                        if n_sides == 2:
                            sp.attrs["real_pairs"] = sum(a * b for a, b in zip(*n))
                        sent = [t for side in sides for t in side[:4]] if sides[0][0].is_cuda else []
                        sp.attrs.update(codes=int(sides[0][1].shape[-1]), h2d_bytes=sum(t.nbytes for t in sent))
                with tracing.span(f"{call_name}.launch", call=cid) as sp:
                    if sp is not None:
                        before = self._launches()
                    result = self._to_host(*self._forward(*sides))
                    if sp is not None:
                        sp.attrs.update({k: v - before[k] for k, v in self._launches().items()})
                return result

            def submit(chunk, in_flight):
                """One chunk's records coded, then the chunk as len(devices)
                equal parts, each on its device with no exchange between
                them: (the items launched, the parts' results), or None when
                no item's codes were made. Over a mesh, a chunk is padded to
                a multiple of the devices by repeating its first item, whose
                copies are never collected."""
                group, key = chunk
                group = code_records(group, in_flight)
                if not group:
                    return None
                dispatch = group + [group[0]] * (-len(group) % ndev)
                per = len(dispatch) // ndev
                results = []
                for k, dev in enumerate(devices):
                    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                        results.append(submit_part(dispatch[k * per : (k + 1) * per], key, dev))
                return group, results

            def collect(group, results):
                with tracing.span(f"{call_name}.collect", sums=self._stages, key="device_wait", call=cid):
                    for _, ready in results:
                        if ready is not None:
                            ready.synchronize()
                    probs = [np.concatenate([hosts[k].numpy() for hosts, _ in results]) for k in range(n_sides)]
                for j, (slot, item) in enumerate(group):
                    out[slot] = item, tuple(p[j, : sizes[r][2]] for p, r in zip(probs, item))

            chunks = []
            for key, group in groups.items():
                bmax = max(ndev, atoms_per_call * ndev // max(na for na, _ in key))
                bmax -= bmax % ndev
                chunks += [(group[k : k + bmax], key) for k in range(0, len(group), bmax)]
            self._pipeline(chunks, submit, collect, pipeline_depth)
            return out

    def predict_batch(self, structures: list, atoms_per_call: int = 32768,
                      num_threads: int = 8, pipeline_depth: int = 2) -> list:
        """Cleaned structure records -> list of [n_res_i, C] probabilities,
        grouped by bucket into chunks of at most `atoms_per_call` padded
        atoms (at least one structure). A record that cannot be encoded
        (EncodeError) or is over the largest bucket (SizeError) gives None
        and a line on stderr; it never fails the others. The records are
        encoded on the caller's thread, each chunk's as it is submitted; up
        to `pipeline_depth` chunks stay in flight on the device while the
        host encodes the next one and reads back the oldest. `num_threads`
        sizes the BatchEncoder's fill pool. While spans are
        recorded (`utils.tracing`), the call is a `predict_batch` span whose
        stages are its children, each with the call's id."""
        if self.dimer:
            raise TypeError("a dimer Predictor answers predict_pairs, not predict_batch")

        def plan(sizes):
            return ((i, f"structure {i}", (i,)) for i, size in enumerate(sizes) if size is not None)

        out = self._schedule("predict_batch", structures, len(structures), plan, 1, atoms_per_call,
                             num_threads, pipeline_depth, structures=len(structures))
        return [o if o is None else o[1][0] for o in out]

    def predict_pairs(self, pairs: list, atoms_per_call: int = 32768, num_threads: int = 8,
                      pipeline_depth: int = 2) -> list:
        """Pairs of cleaned structure records [(a, b)] -> [(probs_a [n_res_a,
        C], probs_b [n_res_b, C])], each side conditioned on the other, in
        the caller's order; needs a dimer Predictor. The stages are
        predict_batch's: each distinct record (by identity) of the call is
        encoded once, on the caller's thread, with the first chunk that
        takes it; each pair is keyed by its sides' (atom, residue) buckets,
        its larger side first (the answer mapped back), and the pairs of a
        key go in chunks of at most `atoms_per_call` padded atoms a side
        (`num_threads` sizes the BatchEncoder's fill pool); a chunk's two
        sides go through the BatchEncoder and the kNN kernel, the forward
        runs both sides' rows as one table (one edge and one
        cross-attention launch a layer), and up to `pipeline_depth` chunks
        stay in flight. A pair
        with a record that cannot be encoded or is over the largest bucket
        gives None (a line on stderr); the other pairs are answered. While
        spans are recorded, the call is a `predict_pairs` span with the
        stages of predict_batch's under the same names."""
        if not self.dimer:
            raise TypeError("predict_pairs needs a dimer Predictor (a CrossPestoModel state dict)")
        index, distinct = {}, []
        for pair in pairs:
            for s in pair:
                if id(s) not in index:
                    index[id(s)] = len(distinct)
                    distinct.append(s)
        sides = [(index[id(a)], index[id(b)]) for a, b in pairs]

        def plan(sizes):
            for i, item in enumerate(sides):
                if sizes[item[0]] is None or sizes[item[1]] is None:
                    continue
                if sizes[item[1]][0] > sizes[item[0]][0]:
                    item = item[::-1]  # the larger side first
                yield i, f"pair {i}", item

        out = self._schedule("predict_pairs", distinct, len(pairs), plan, 2, atoms_per_call,
                             num_threads, pipeline_depth, pairs=len(pairs))
        return [o if o is None else o[1] if o[0] == want else o[1][::-1] for o, want in zip(out, sides)]

    def predict_pdb_files(self, paths: list, num_threads: int = 8, atoms_per_call: int = 32768,
                          pipeline_depth: int = 2) -> Tuple[list, list]:
        """PDB/mmCIF paths -> (structures, probs), aligned with `paths`.
        The files are read and cleaned in a pool of `num_threads` threads,
        then predicted by predict_batch. A file that cannot be read gives
        (None, None) and a ReadError on stderr; a structure that cannot be
        predicted gives (structure, None)."""

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
