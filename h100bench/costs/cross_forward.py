"""Operations of the dimer's whole forward over one pair, from the layer
equations at the configuration's widths: each structure's embedding,
state updates, residue pool and decoder as `pesto_forward` counts them,
plus in every layer the four cross MLPs on each real atom (queries, keys,
values and the output MLP on [q, the heads' sums]) and the cross
attention of the pair (`cross_attn`). Real atoms and residues only. A
multiply-add is 2 operations."""

import importlib.util
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(f"h100bench_costs_{name}", os.path.join(_HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pesto_forward = _load("pesto_forward")
cross_attn = _load("cross_attn")


def cross_mlp_macs(S=32, cNh=2, cNk=3) -> int:
    """Multiply-adds of the four cross MLPs on one atom in one layer."""
    mlp = pesto_forward._mlp
    return (mlp(2 * S, (S, S, cNk * cNh)) + mlp(2 * S, (S, S, cNk)) + mlp(2 * S, (S, S, S))
            + mlp(S + cNh * S, (S, S, S)))


def flops(cfg: dict, n_a: int, r_a: int, n_b: int, r_b: int) -> int:
    S, cNh, cNk = cfg["Ns"], cfg["cross"]["cNh"], cfg["cross"]["cNk"]
    layers = len(cfg["nn"])
    return (pesto_forward.flops(cfg, n_a, r_a) + pesto_forward.flops(cfg, n_b, r_b)
            + 2 * (n_a + n_b) * layers * cross_mlp_macs(S, cNh, cNk)
            + layers * cross_attn.cost(n_a, n_b, S, cNh, cNk)[0])
