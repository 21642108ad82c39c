"""The plain reference of PeSTo's geometric transformer: float32 PyTorch,
one structure at a time, no padding, no kernels.

It follows the published model (LBM-EPFL/PeSTo, src/model_operations.py
and model/model.py): an embedding MLP, state-update layers over each
atom's nn nearest neighbours, an atom-to-residue attention pool and a
decoder MLP. Departures, each exact up to rounding: the residue pool is a
softmax over each residue's own atoms (the published model adds a filter of
-1e6 to every other atom, whose exponential is 0 in float32); the vector
norms are floored at sqrt(1e-36), as the port's are. Parameter names are
the published model's, so one state dict serves the reference and the
program.

Every product runs in float32 with TF32 off (`precision("float32")`);
the control runs the same code with TF32 on (`precision("tf32")`).
"""

import contextlib
import math

import torch
from torch import nn

# the input vocabularies of the published data encoding
# (src/data_encoding.py): 29 elements, 28 residue names, 63 atom names,
# each one-hot with a trailing "other" column
STD_ELEMENTS = ("C", "O", "N", "S", "P", "Se", "Mg", "Cl", "Zn", "Fe", "Ca", "Na", "F", "Mn", "I",
                "K", "Br", "Cu", "Cd", "Ni", "Co", "Sr", "Hg", "W", "As", "B", "Mo", "Ba", "Pt")
STD_RESNAMES = ("LEU", "GLU", "ARG", "LYS", "VAL", "ILE", "PHE", "ASP", "TYR", "ALA", "THR", "SER",
                "GLN", "ASN", "PRO", "GLY", "HIS", "TRP", "MET", "CYS", "G", "A", "C", "U", "DG",
                "DA", "DT", "DC")
STD_NAMES = ("CA", "N", "C", "O", "CB", "CG", "CD2", "CD1", "CG1", "CG2", "CD", "OE1", "OE2", "OG",
             "OG1", "OD1", "OD2", "CE", "NZ", "NE", "CZ", "NH2", "NH1", "ND2", "CE2", "CE1", "NE2",
             "OH", "ND1", "SD", "SG", "NE1", "CE3", "CZ3", "CZ2", "CH2", "P", "C3'", "C4'", "O3'",
             "C5'", "O5'", "O4'", "C1'", "C2'", "O2'", "OP1", "OP2", "N9", "N2", "O6", "N7", "C8",
             "N1", "N3", "C2", "C4", "C6", "C5", "N6", "N4", "O2", "O4")
VOCABS = {"element": STD_ELEMENTS, "resname": STD_RESNAMES, "name": STD_NAMES}


@contextlib.contextmanager
def precision(kind: str):
    """Products in float32 ("float32", TF32 off) or in TF32 ("tf32")."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = {"float32": False, "tf32": True}[kind]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def safe_norm(x, dim):
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=1e-36))


def mlp(n_in, widths):
    mods = []
    for i, w in enumerate(widths):
        mods.append(nn.Linear(n_in, w))
        if i + 1 < len(widths):
            mods.append(nn.ELU())
        n_in = w
    return nn.Sequential(*mods)


class StateUpdate(nn.Module):
    """One layer: each atom attends over its nn neighbours with a scalar
    and a vector head (src/model_operations.py StateUpdate)."""

    def __init__(self, S, Nh, Nk):
        super().__init__()
        self.S, self.Nh, self.Nk = S, Nh, Nk
        self.nqm = mlp(2 * S, (S, S, 2 * Nk * Nh))
        self.eqkm = mlp(6 * S + 1, (S, S, Nk))
        self.epkm = mlp(6 * S + 1, (S, S, 3 * Nk))
        self.evm = mlp(6 * S + 1, (2 * S, 2 * S, 2 * S))
        self.qpm = mlp(Nh * S, (S, S, S))
        self.ppm = nn.Sequential(nn.Linear(Nh * S, S, bias=False))
        self.register_buffer("sdk", torch.sqrt(torch.tensor(float(Nk))))

    def forward(self, q, p, ids, d, r):
        """q [n,S], p [n,3,S], ids [n,nn], d [n,nn], r [n,nn,3]."""
        S, Nh, Nk = self.S, self.Nh, self.Nk
        n, k = ids.shape
        q_nn, p_nn = q[ids], p[ids]                                   # [n,k,S], [n,k,3,S]
        X_n = torch.cat([q, safe_norm(p, 1)], dim=1)
        p_proj = (p[:, None] * r[..., None]).sum(dim=2)
        pnn_proj = (p_nn * r[..., None]).sum(dim=2)
        X_e = torch.cat([d[..., None], X_n[:, None].expand(n, k, 2 * S), q_nn,
                         safe_norm(p_nn, 2), p_proj, pnn_proj], dim=2)
        Q = self.nqm(X_n).reshape(n, 2, Nh, Nk)
        Kq = self.eqkm(X_e)
        Kp = torch.cat(torch.split(self.epkm(X_e), Nk, dim=2), dim=1)  # [n,3k,Nk]
        V = self.evm(X_e).reshape(n, k, 2, S)
        Vp = torch.cat([V[:, :, 1, None] * r[..., None], p[:, None].expand(n, k, 3, S), p_nn],
                       dim=1).transpose(1, 2)                          # [n,3,3k,S]
        Mq = torch.softmax(torch.einsum("nhk,nmk->nhm", Q[:, 0], Kq) / self.sdk, dim=2)
        Mp = torch.softmax(torch.einsum("nhk,nmk->nhm", Q[:, 1], Kp) / self.sdk, dim=2)
        Zq = torch.einsum("nhm,nms->nhs", Mq, V[:, :, 0]).reshape(n, Nh * S)
        Zp = torch.einsum("nhm,nxms->nxhs", Mp, Vp).reshape(n, 3, Nh * S)
        return q + self.qpm(Zq), p + self.ppm(Zp)


class StateUpdateLayer(nn.Module):
    def __init__(self, S, Nh, Nk, nn_):
        super().__init__()
        self.su = StateUpdate(S, Nh, Nk)
        self.register_buffer("m_nn", torch.arange(nn_, dtype=torch.int64))


class StatePool(nn.Module):
    """Atom -> residue attention pool (src/model_operations.py
    StatePoolLayer), as a softmax over each residue's atoms."""

    def __init__(self, N0, N1, Nh):
        super().__init__()
        self.Nh = Nh
        self.sam = mlp(2 * N0, (N0, N0, 2 * Nh))
        self.zdm = mlp(Nh * N0, (N0, N0, N1))
        self.zdm_vec = nn.Sequential(nn.Linear(Nh * N0, N1, bias=False))

    def forward(self, q, p, res, n_res):
        """q [n,S], p [n,3,S], res [n] residue index of each atom."""
        n, S = q.shape
        s = self.sam(torch.cat([q, safe_norm(p, 1)], dim=1))          # [n, 2Nh]
        smax = s.new_full((n_res, s.shape[1]), -math.inf)
        smax = smax.scatter_reduce(0, res[:, None].expand_as(s), s, "amax")
        e = torch.exp(s - smax[res])
        den = s.new_zeros(n_res, s.shape[1]).index_add_(0, res, e)
        w = (e / den[res]).reshape(n, self.Nh, 2)                      # (head, q|p)
        qh = q.new_zeros(n_res, S, self.Nh).index_add_(
            0, res, q[:, :, None] * w[:, None, :, 0])
        ph = q.new_zeros(n_res, 3, S, self.Nh).index_add_(
            0, res, p[..., None] * w[:, None, None, :, 1])
        # flattening is (state, head)-major, as the published view()
        return self.zdm(qh.reshape(n_res, -1)), self.zdm_vec(ph.reshape(n_res, 3, -1))


class Model(nn.Module):
    """Embedding -> state-update layers -> pool -> decoder (model/model.py)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        S, Nh, Nk = cfg["Ns"], cfg["Nh"], cfg["Nk"]
        em = (cfg["em_n1"],) if cfg["em_single"] else (cfg["em_n1"],) * 3
        self.em = mlp(cfg["em_n0"], em)
        self.sum = nn.ModuleList(StateUpdateLayer(S, Nh, Nk, k) for k in cfg["nn"])
        self.spl = StatePool(cfg["spl_n0"], cfg["spl_n1"], cfg["spl_nh"])
        dm = (cfg["dm_n2"],) if cfg["dm_single"] else (cfg["dm_n1"], cfg["dm_n1"], cfg["dm_n2"])
        self.dm = mlp(2 * cfg["spl_n1"], dm)

    def forward(self, q0, ids, d, r, res, n_res, checkpoint=False):
        """q0 [n,F] features, ids [n,64] neighbour indices, d [n,64], r
        [n,64,3], res [n] residue index -> logits [n_res, C]."""
        q = self.em(q0)
        p = q.new_zeros(q.shape[0], 3, q.shape[1])
        for layer in self.sum:
            k = int(layer.m_nn.shape[0])
            args = (q, p, ids[:, :k], d[:, :k], r[:, :k])
            if checkpoint:
                q, p = torch.utils.checkpoint.checkpoint(layer.su, *args, use_reentrant=False)
            else:
                q, p = layer.su(*args)
        qr, pr = self.spl(q, p, res, n_res)
        return self.dm(torch.cat([qr, safe_norm(pr, 1)], dim=1))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The state dict of a seed, made on `device` in one call: every
    Linear's weight uniform with LeCun's variance 1/fan_in (torch's default,
    a third of it, leaves the 32-layer model's output all but independent
    of its input), its bias uniform in +-1/sqrt(fan_in), and the buffers."""
    with torch.device("meta"):
        shapes = {k: v for k, v in Model(cfg).state_dict().items()}
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


def features(rec: dict, cfg: dict) -> torch.Tensor:
    """The one-hot input features [n, em_n0] of a structure record, from
    the vocabularies the configuration names."""
    import numpy as np

    cols = []
    for field in cfg["features"]:
        vocab = np.array(VOCABS[field])
        hit = np.asarray(rec[field]).reshape(-1, 1) == vocab.reshape(1, -1)
        cols.append(np.concatenate([hit, ~hit.any(1, keepdims=True)], 1))
    q = np.concatenate(cols, 1).astype(np.float32)
    if q.shape[1] != cfg["em_n0"]:
        raise ValueError(f"features {cfg['features']} give {q.shape[1]} columns, config has {cfg['em_n0']}")
    return torch.from_numpy(q)


def residues(rec: dict):
    """(residue index of each atom [n], residue count): residues in order
    of their number, as the published encoding's unique()."""
    import numpy as np

    _, inv = np.unique(np.asarray(rec["resid"]), return_inverse=True)
    return torch.from_numpy(inv.astype(np.int64)), int(inv.max()) + 1


def geometry(X: torch.Tensor, ids: torch.Tensor):
    """(d [n,k], r [n,k,3]) of each atom's neighbours: distances (one under
    1e-2 moved out by the largest, as the published encoding does) and unit
    displacements."""
    R = X[ids] - X[:, None, :]
    d = safe_norm(R, 2)
    d = d + d.max() * (d < 1e-2).to(d.dtype)
    return d, R / d[..., None]


def logits(model: Model, rec: dict, ids: torch.Tensor, device, checkpoint=False) -> torch.Tensor:
    """Per-residue logits [n_res, C] of one record, given its neighbour ids."""
    res, n_res = residues(rec)
    return logits_of(model, torch.from_numpy(rec["xyz"]), ids, features(rec, model.cfg), res, n_res,
                     device, checkpoint)


def logits_of(model: Model, X, ids, q0, res, n_res: int, device, checkpoint=False) -> torch.Tensor:
    """Per-residue logits [n_res, C] from coordinates [n,3], neighbour ids
    [n,64], features [n,F] and residue indices [n], in the model's dtype."""
    dt = next(model.parameters()).dtype
    X = torch.as_tensor(X).to(device, torch.float32).to(dt)
    d, r = geometry(X, torch.as_tensor(ids).to(device))
    return model(torch.as_tensor(q0).to(device, dt), torch.as_tensor(ids).to(device), d, r,
                 torch.as_tensor(res).to(device), n_res, checkpoint=checkpoint)
