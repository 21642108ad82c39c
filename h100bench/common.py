"""What the drivers share: the program's configuration from a config file,
the seeded sample of answers to check, the reference's probabilities and
the freeing of the program's state before the reference runs."""

import gc

import numpy as np
import torch

from h100bench.reference import knn as ref_knn
from h100bench.reference import pesto as ref


def program_config(cfg: dict):
    """The port's PestoConfig with the configuration file's sizes."""
    from pesto_tpu_torch.models.config import LayerConfig, PestoConfig

    pc = PestoConfig(
        em_n0=cfg["em_n0"], em_n1=cfg["em_n1"], em_single=cfg["em_single"],
        layers=tuple(LayerConfig(Ns=cfg["Ns"], Nh=cfg["Nh"], Nk=cfg["Nk"], nn=k) for k in cfg["nn"]),
        spl_n0=cfg["spl_n0"], spl_n1=cfg["spl_n1"], spl_nh=cfg["spl_nh"],
        dm_n0=cfg["dm_n0"], dm_n1=cfg["dm_n1"], dm_n2=cfg["dm_n2"], dm_single=cfg["dm_single"],
        dtype=cfg["dtype"])
    want = tuple(f in cfg["features"] for f in ("element", "resname", "name"))
    if tuple(pc.feature_flags) != want:
        raise ValueError(f"the program reads features {pc.feature_flags}, the config states {cfg['features']}")
    return pc


def free_memory() -> None:
    """Return the memory of objects the caller dropped to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_probs(cfg: dict, seed: int, records: list, device, kinds=("float32",)) -> dict:
    """{kind: [probabilities [n_res, C] per record]} of the reference with
    the seed's weights, one record at a time, in each precision of `kinds`:
    "float32", "tf32" (the control) or "float64" (the unit of the
    comparison). Neighbours by float64 direct differences."""
    dev = torch.device(device)
    weights = ref.make_weights(cfg, seed, dev)
    models = {}
    for kind in kinds:
        models[kind] = ref.Model(cfg).to(dev, torch.float64 if kind == "float64" else torch.float32)
        models[kind].load_state_dict(weights)
        models[kind].eval()
    out = {k: [] for k in kinds}
    with torch.no_grad():
        for rec in records:
            ids = ref_knn.knn(torch.from_numpy(rec["xyz"]).to(dev))
            for kind in kinds:
                with ref.precision("float32" if kind == "float64" else kind):
                    z = ref.logits(models[kind], rec, ids, dev)
                out[kind].append(torch.sigmoid(z).double().cpu().numpy())
    return out


def prob_gaps(cfg, seed, records, answers, device, control=False) -> dict:
    """Gaps of the answers (probabilities [n_res, C] or None) from the
    reference's over the records. The number compared, `answer_error_ratio`:
    each answer's mean gap from the reference run in float64, in units of
    the float32 reference's own mean gap from it on that answer (or on the
    median answer, whichever is larger); the worst answer's. Readings
    beside it: `prob_gap`, the widest gap from the float32 reference over
    every residue and class, and `prob_answer_gap`, the worst answer's mean
    gap from it. With `control`, the same of the reference run in TF32
    (`.control`). A missing answer or one of another shape reads inf."""
    kinds = ("float32", "float64") + (("tf32",) if control else ())
    ref_p = reference_probs(cfg, seed, records, device, kinds)
    own = [float(np.abs(f - w).mean()) for f, w in zip(ref_p["float32"], ref_p["float64"])]
    unit = [max(o, float(np.median(own))) for o in own]

    def numbers(got_all, tag=""):
        widest = answer = ratio = 0.0
        for got, f32, f64, u in zip(got_all, ref_p["float32"], ref_p["float64"], unit):
            if got is None or np.shape(got) != f32.shape:
                return {f"{k}{tag}": np.inf for k in ("answer_error_ratio", "prob_gap", "prob_answer_gap")}
            got = np.asarray(got, np.float64)
            d = np.abs(got - f32)
            widest, answer = max(widest, float(d.max())), max(answer, float(d.mean()))
            ratio = max(ratio, float(np.abs(got - f64).mean()) / u)
        return {f"answer_error_ratio{tag}": ratio, f"prob_gap{tag}": widest, f"prob_answer_gap{tag}": answer}

    out = numbers(answers)
    if control:
        out.update(numbers(ref_p["tf32"], ".control"))
    out["float32_own_gap"] = float(np.median(own))
    return out
