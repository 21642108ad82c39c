"""Atom-sharded (sequence-parallel) forward and the 2-D (data x atoms)
train step (port of `pesto_tpu/parallel/sp.py`).

A mesh's rows take the structures of a batch (the data axis) and its
columns split every structure's NA padded rows into contiguous shards (the
model axis). One process drives every device (the JAX package lets GSPMD
place the same collectives). Per forward, for each data row:
  - the atom count and Dmax, each a reduction over the row's shards
    (`comm.all_sum`, `comm.all_max`), and from them the geometry of each
    shard's rows from the row's coordinates, which every device of the row
    holds whole (models/pesto.py `neighbour_vectors`);
  - per layer, an all-gather of every shard's [q | p] rows into one table
    on each device (`comm.all_gather_rows`), then the edge attention of
    the shard's own rows against that table (the kernel's table and
    offset, `ops.edge_attention`) and the shard's own state update. With
    B structures per row the table is shard-major: shard j's rows of the
    B structures, structure by structure, form one block, so a shard's
    rows stay contiguous and each shard makes one launch per layer; the
    neighbour ids are remapped into that layout once per forward
    (`table_rows`);
  - the residue pool's softmax over atoms as a cross-shard softmax: each
    shard's max, sum of exponentials and weighted sums over its own
    [B, n, NR, 2Nh] block (`StatePool.partial`).
Then once, on the mesh's first device: every shard's pool parts
(`comm.merge_to`), each row's log-sum-exp merge (`StatePool.merge`) and
the decoder over the whole batch. No device holds the dense [NA, NR, 2Nh]
of a whole structure.

The forward reuses the model's own submodules, one replica per distinct
device, and is differentiable: `Tensor.to` and `torch.cat` carry autograd
across devices, the edge kernel runs inside `EdgeAttentionFunction`. The
train step (`make_sp_train_step`) runs the loss on the first device, sums
the gradients of the replicas into the master's and copies the master's
weights back after Adam.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..batching import PaddedStructure
from ..models.pesto import finish_state_features, neighbour_vectors, onehot_codes, safe_norm
from ..train.loss import masked_bce_with_pos_weight, update_pos_ratios
from . import comm
from .mesh import canonical, replicate


def table_rows(bounds, B: int, device) -> torch.Tensor:
    """[B, NA] int64: the row, in the shard-major table of B structures
    whose atom rows split at `bounds` [(a, b), ...], of each structure's
    atom row. Shard j's block starts at B * a_j and holds its n_j rows of
    structure 0, then of structure 1, ...; for B = 1 the map is the
    identity."""
    arange = lambda n: torch.arange(n, device=device)  # noqa: E731
    return torch.cat([B * a + arange(B)[:, None] * (b - a) + arange(b - a) for a, b in bounds], dim=1)


def _cell_state(model, dev, cell, a, geometry, dmax, rows, nr, dtype):
    """One shard's inputs to the layer stack: its atoms' rows, flattened
    structure-major, with the ids remapped by `rows` (`table_rows`) into
    the shard-major table."""
    cfg = model.cfg
    q0, M, am = cell["q0"], cell["M"], cell["am"]
    Bi, n = am.shape
    R, D, _ = geometry
    with torch.no_grad():  # geometry: the coordinates carry no gradient
        D, R = finish_state_features(R, D, dmax, am)
        ids = rows.gather(1, cell["ids"].reshape(Bi, -1).long()).reshape(Bi * n, -1)
    if not torch.is_floating_point(q0):
        q0 = onehot_codes(q0, cfg.em_n0)
    if not torch.is_floating_point(M):
        M = (M[..., None] == torch.arange(nr, device=dev)).to(torch.float32) * am[..., None]
    am_flat = am.reshape(-1)
    q = model.em(q0.reshape(Bi * n, -1).to(dtype)) * am_flat.to(dtype)[:, None]
    return dict(dev=dev, model=model, row0=Bi * a, Bi=Bi, am=am_flat, ids=ids.to(torch.int32).contiguous(),
                D=D.reshape(Bi * n, -1).to(dtype), R=R.reshape(Bi * n, -1, 3).to(dtype), M=M, q=q,
                p=torch.zeros((Bi * n, 3, cfg.em_n1), dtype=dtype, device=dev))


def sharded_logits(replicas: dict, grid: list, cells: list, bounds: list, nr: Optional[int] = None,
                   n_real: Optional[list] = None) -> torch.Tensor:
    """Logits [B, NR, C] on grid[0][0] of the structures in `cells`.

    replicas: {device: the model there}; grid: [n_rows][n_cols] devices;
    cells[i][j] on grid[i][j]: dict(X [Bi, NA, 3] fp32, data row i's
    structures whole; ids [Bi, n_j, K] their neighbour ids (structure
    rows 0..NA-1); q0, M dense or integer codes and am [Bi, n_j] fp32 of
    their atom rows bounds[j] = (a_j, b_j)). nr: the residue count of
    integer M. n_real: per row the real atom count of each structure
    [Bi]; None sums it over the row's shards (one collective per row)."""
    first = grid[0][0]
    master = replicas[first]
    dtype = master.em[0].weight.dtype
    if any(not torch.is_floating_point(c["M"]) for row in cells for c in row) and nr is None:
        raise ValueError("compact M (residue codes) requires nr")
    rows = []
    for i, (devs, row) in enumerate(zip(grid, cells)):
        Bi = row[0]["am"].shape[0]
        # Dmax and the atom count depend only on the coordinates X, which
        # carry no gradient: these reductions run outside autograd
        with torch.no_grad():
            if n_real is None:
                counts = comm.all_sum([c["am"].sum(dim=1) for c in row], devs)
            else:
                counts = [n_real[i].to(d, non_blocking=True) for d in devs]
            geometry = [neighbour_vectors(c["X"], c["ids"], c["am"], cnt.to(torch.int64), row0=a)
                        for c, cnt, (a, _) in zip(row, counts, bounds)]
            dmax = comm.all_max([g[2] for g in geometry], devs)
        maps = {d: table_rows(bounds, Bi, d) for d in dict.fromkeys(devs)}
        rows.append([_cell_state(replicas[d], d, c, a, g, m, maps[d], nr, dtype)
                     for c, d, (a, _), g, m in zip(row, devs, bounds, geometry, dmax)])

    for li in range(len(master.sum)):
        for devs, shards in zip(grid, rows):
            tables = comm.all_gather_rows(
                [torch.cat([s["q"], s["p"].reshape(len(s["q"]), -1)], dim=1) for s in shards], devs)
            for s in shards:
                s["q"], s["p"] = s["model"].sum[li](s["q"], s["p"], s["ids"], s["D"], s["R"], s["am"],
                                                    table=tables[s["dev"]], row0=s["row0"])
            del tables

    parts = [s["model"].spl.partial(s["q"].reshape(s["Bi"], -1, s["q"].shape[-1]),
                                    s["p"].reshape(s["Bi"], -1, 3, s["p"].shape[-1]), s["M"])
             for shards in rows for s in shards]
    parts = comm.merge_to(parts, first)
    pooled, k = [], 0
    for shards in rows:
        pooled.append(master.spl.merge(parts[k : k + len(shards)], dtype))
        k += len(shards)
    qr = torch.cat([q for q, _ in pooled])
    pr = torch.cat([p for _, p in pooled])
    return master.dm(torch.cat([qr, safe_norm(pr, -2)], dim=-1))


class ShardedForward:
    """forward(X, ids_topk, q0, M, atom_mask, nr=None) -> logits [NR, C] on
    the first device, for one padded structure (X [NA, 3], ids_topk
    [NA, K], q0 and M dense or integer codes, atom_mask [NA]) with its rows
    split over `devices` in order (a device may repeat), without gradient.
    The one-row case of `sharded_logits`, its atom count taken from the
    whole atom_mask (no collective for it)."""

    def __init__(self, model, devices):
        self.devices = [canonical(d) for d in devices]
        self.replicas = replicate(model, self.devices)

    def bounds(self, NA: int) -> list:
        """The contiguous rows (start, end) of each shard."""
        W = len(self.devices)
        return [(k * NA // W, (k + 1) * NA // W) for k in range(W)]

    @torch.no_grad()
    def __call__(self, X, ids_topk, q0, M, atom_mask, nr=None):
        bounds = self.bounds(X.shape[0])
        n_real = atom_mask.to(torch.float32).sum().to(torch.int64).reshape(1)
        cells = [dict(X=X.to(dev, non_blocking=True).to(torch.float32)[None],
                      ids=ids_topk[a:b].to(dev, non_blocking=True)[None],
                      q0=q0[a:b].to(dev, non_blocking=True)[None], M=M[a:b].to(dev, non_blocking=True)[None],
                      am=atom_mask[a:b].to(dev, non_blocking=True).to(torch.float32)[None])
                 for dev, (a, b) in zip(self.devices, bounds)]
        return sharded_logits(self.replicas, [self.devices], [cells], bounds, nr, n_real=[n_real])[0]


# ---- the 2-D layout: batch over the data axis, atoms over the model axis ----


@dataclasses.dataclass
class ShardedBatch:
    """A batch placed on a mesh by `shard_batch_sp`. cells[i][j], on the
    mesh's device (i, j), is a PaddedStructure of data row i's structures:
    X whole ([Bi, NA, 3]: the geometry gathers coordinates by neighbour
    id), ids_topk, q, M and atom_mask their atom rows bounds[j]; res_mask
    and y on the row's first cell (j = 0) and None on the others."""

    cells: list
    bounds: list


def shard_batch_sp(batch: PaddedStructure, mesh) -> ShardedBatch:
    """Place a batch ([B, NA, ...] numpy arrays or tensors) on the mesh:
    its B structures split in n_data contiguous blocks over the data axis,
    its NA atom rows in n_model contiguous blocks over the model axis.
    Raises ValueError when either does not divide."""
    n_data, n_model = mesh.devices.shape
    t = lambda x: x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    X = t(batch.X)
    B, NA = X.shape[:2]
    if B % n_data:
        raise ValueError(f"a batch of {B} structures does not split over {n_data} data rows")
    if NA % n_model:
        raise ValueError(f"{NA} atom rows do not split over {n_model} model columns")
    Bi, n = B // n_data, NA // n_model
    bounds = [(j * n, (j + 1) * n) for j in range(n_model)]
    fields = {f: t(getattr(batch, f)) for f in ("ids_topk", "q", "M", "atom_mask", "res_mask", "y")
              if getattr(batch, f) is not None}
    cells = []
    for i in range(n_data):
        s = slice(i * Bi, (i + 1) * Bi)
        row = []
        for j, (a, b) in enumerate(bounds):
            dev = canonical(mesh.devices[i, j])
            put = lambda x: x.to(dev, non_blocking=True)  # noqa: E731
            atoms = {f: put(fields[f][s, a:b]) for f in ("ids_topk", "q", "M", "atom_mask")}
            labels = {f: put(fields[f][s]) if j == 0 and f in fields else None for f in ("res_mask", "y")}
            row.append(PaddedStructure(X=put(X[s]), **atoms, **labels))
        cells.append(row)
    return ShardedBatch(cells, bounds)


class _Replicas(nn.Module):
    """The distinct replicas as one module, so that `functional_call` puts
    cast weights in place on all of them for one call."""

    def __init__(self, modules):
        super().__init__()
        self.r = nn.ModuleList(modules)

    def forward(self, fn):
        return fn()


class MeshForward:
    """forward(X, ids_topk, q0, M, atom_mask, nr=None) -> logits [B, NR, C]
    on the mesh's first device, for a batch of padded structures ([B, NA,
    ...]) with its structures over the mesh's data axis and its atom rows
    over the model axis (JAX's make_sp_forward(batch_axis=True)). Autograd
    records unless the caller turns it off: the train step runs it."""

    def __init__(self, model, mesh):
        self.mesh = mesh
        self.grid = [[canonical(d) for d in row] for row in mesh.devices]
        self.replicas = replicate(model, [d for row in self.grid for d in row])

    def __call__(self, X, ids_topk, q0, M, atom_mask, nr=None):
        return self.run(shard_batch_sp(PaddedStructure(X, ids_topk, q0, M, atom_mask, None), self.mesh), nr)

    def run(self, batch: ShardedBatch, nr=None, compute_dtype=torch.float32) -> torch.Tensor:
        """The logits of a placed batch, computed in `compute_dtype`: the
        replicas' fp32 weights, or each of them cast (train/step.py's
        `batched_forward`, here on every replica at once)."""
        cells = [[dict(X=c.X.to(torch.float32), ids=c.ids_topk, q0=c.q, M=c.M, am=c.atom_mask.to(torch.float32))
                  for c in row] for row in batch.cells]

        def logits():
            return sharded_logits(self.replicas, self.grid, cells, batch.bounds, nr)

        if compute_dtype == torch.float32:
            return logits()
        holder = _Replicas(list(dict.fromkeys(self.replicas.values())))
        weights = {f"r.{i}.{k}": w.to(compute_dtype) for i, m in enumerate(holder.r)
                   for k, w in m.named_parameters()}
        return torch.func.functional_call(holder, weights, (logits,))


def make_sp_forward(model, mesh, batch_axis: bool = False):
    """The model's forward with the atoms sharded over the mesh's model
    axis. batch_axis=False: one structure over the first row of devices
    (`ShardedForward`, no gradient); batch_axis=True: a batch, its
    structures over the data axis too (`MeshForward`)."""
    if batch_axis:
        return MeshForward(model, mesh)
    return ShardedForward(model, mesh.model_devices())


def make_sp_train_step(mesh, pos_weight_factor: float = 0.5):
    """train_step(state, batch, mark=None) -> (state, {"loss", "losses",
    "p"}) with the batch's structures over the mesh's data axis and their
    atoms over its model axis; the parameters and Adam are replicated (the
    counterpart of `train.step.make_train_step`). `batch` is a
    `shard_batch_sp` result or a host batch, which the step places. The
    state's model is the master and must live on the mesh's first device;
    the replicas on its other distinct devices are made at the first step
    with that model, and a master changed in place between steps (a
    restored checkpoint) is copied onto them before the next forward. One
    step, in order: pos_ratios from the whole batch's
    counts (the labels gathered on the first device), the sharded forward,
    the loss on fp32 logits on the first device, the backward across the
    devices, the replicas' gradients summed into the master's
    (`comm.sum_grads_to`), one Adam update, and the master's weights copied
    onto the replicas (`comm.copy_params`). "p" is on the first device.
    `mark`, if given, is called with "forward", "backward" and "optimizer"
    as each part ends."""
    cache = {}

    def versions(model):
        return [w._version for w in model.parameters()]

    def forward_of(state) -> MeshForward:
        if cache.get("model") is not state.model:
            fwd = MeshForward(state.model, mesh)
            if fwd.replicas[fwd.grid[0][0]] is not state.model:
                raise ValueError(f"the train state's model lives on {state.device}, not on the mesh's first "
                                 f"device {fwd.grid[0][0]}")
            cache.update(model=state.model, fwd=fwd, versions=versions(state.model))
        return cache["fwd"]

    def train_step(state, batch, mark=None):
        fwd = forward_of(state)
        first = fwd.grid[0][0]
        others = [m for m in dict.fromkeys(fwd.replicas.values()) if m is not state.model]
        if others and versions(state.model) != cache["versions"]:
            comm.copy_params(state.model, others)
        if not isinstance(batch, ShardedBatch):
            batch = shard_batch_sp(batch, mesh)
        step = state.global_step + 1
        labels = comm.merge_to([(row[0].y, row[0].res_mask) for row in batch.cells], first)
        y = torch.cat([lab[0] for lab in labels])
        res_mask = torch.cat([lab[1] for lab in labels])
        with torch.no_grad():
            pos_ratios = update_pos_ratios(state.pos_ratios, y, res_mask, step)
        z = fwd.run(batch, nr=res_mask.shape[-1], compute_dtype=state.compute_dtype).to(torch.float32)
        per_class, total = masked_bce_with_pos_weight(z, y, res_mask, pos_ratios, pos_weight_factor)
        p = torch.sigmoid(z.detach())
        if mark:
            mark("forward")
        state.optimizer.zero_grad(set_to_none=True)
        for m in others:
            m.zero_grad(set_to_none=True)
        total.backward()
        comm.sum_grads_to(state.model, others)
        if mark:
            mark("backward")
        state.apply_gradients()
        comm.copy_params(state.model, others)
        cache["versions"] = versions(state.model)
        if mark:
            mark("optimizer")
        state.pos_ratios = pos_ratios
        state.global_step = step
        return state, {"loss": total.detach(), "losses": per_class.detach(), "p": p}

    train_step.forward = forward_of  # the MeshForward of a state: its replicas
    return train_step
