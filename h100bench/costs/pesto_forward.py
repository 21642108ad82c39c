"""Operations of the whole model's forward over one structure, from the
layer equations at the configuration's widths: the embedding, every
state-update layer (its edge attention as `edge_fwd` counts it, the query
MLP, the two output projections), the residue pool and the decoder.
Real atoms and residues only: padding is waste. A multiply-add is 2
operations."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "h100bench_costs_edge_fwd", os.path.join(os.path.dirname(os.path.abspath(__file__)), "edge_fwd.py"))
edge_fwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(edge_fwd)


def _mlp(n_in, widths):
    macs = 0
    for w in widths:
        macs += n_in * w
        n_in = w
    return macs


def flops(cfg: dict, n: int, n_res: int) -> int:
    S, Nh, Nk = cfg["Ns"], cfg["Nh"], cfg["Nk"]
    em = (cfg["em_n1"],) if cfg["em_single"] else (cfg["em_n1"],) * 3
    macs = n * _mlp(cfg["em_n0"], em)
    layer_atom = 3 * S + _mlp(2 * S, (S, S, 2 * Nk * Nh)) + _mlp(Nh * S, (S, S, S)) + 3 * Nh * S * S
    total = 0
    for nn in cfg["nn"]:
        total += edge_fwd.cost(n, nn, S, Nh, Nk)[0]
        macs += n * layer_atom
    N0, N1, H = cfg["spl_n0"], cfg["spl_n1"], cfg["spl_nh"]
    macs += n * (3 * N0 + _mlp(2 * N0, (N0, N0, 2 * H)) + 4 * N0 * H)
    dm = (cfg["dm_n2"],) if cfg["dm_single"] else (cfg["dm_n1"], cfg["dm_n1"], cfg["dm_n2"])
    macs += n_res * (_mlp(H * N0, (N0, N0, N1)) + 3 * H * N0 * N1 + 3 * N1 + _mlp(2 * N1, dm))
    return total + 2 * macs
