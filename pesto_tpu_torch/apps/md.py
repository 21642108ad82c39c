"""MD-trajectory interface prediction (port of `pesto_tpu/apps/md.py`).

The reference pipeline (md_analysis/apply_model_md.ipynb cells 1,5-6):
topology and kNN graph frozen at frame 0, only coordinates change per
frame (D_nn/R_nn are recomputed inside the model), predictions per frame
compared to the contacts of the bound reference complex via ROC AUC.

Frames run in batches: one chunk of frames is one forward over B copies of
the structure that share its neighbour ids, on the GPU unless --device cpu
is given.

Usage:
  python -m pesto_tpu_torch.apps.md TRAJ.pdb --ref COMPLEX.pdb \\
      (--ckpt model.pt | --train-ckpt DIR) [--model i_v4_0] [--bf16] \\
      [--receptor-chains A] [--every 100] [--chunk 8] [--out results.csv] \\
      [--device cuda|cpu]
"""

import argparse
import csv

import numpy as np
import torch

from .apply_model import add_weight_args


def predict_trajectory(predictor, structure, xyz_frames, chunk: int = 8):
    """Per-frame per-residue probabilities [T, n_res, C] (numpy) with the
    kNN topology frozen from the structure's own coordinates, frame 0 of a
    trajectory (reference nb cell 6). One kNN launch for the topology, then
    one forward per chunk of frames on the predictor's device: the frames'
    coordinates fill rows 1..n (row 0 is the sink), and the ids, features
    and residue codes are those of the one structure, shared by the chunk
    (integer codes, as predict_batch encodes them)."""
    from ..batching import encode_record, pad_record
    from ..ops.knn import knn_ids

    dev = predictor.device
    Xp, q, M, am, n_res, nr = pad_record(encode_record(structure, predictor.cfg))
    na, n = Xp.shape[0], structure["xyz"].shape[0]
    Xp, q, M, am = (torch.as_tensor(x).to(dev) for x in (Xp, q, M, am))
    ids = knn_ids(Xp[None], am[None])[0][0]

    probs = []
    with torch.no_grad():
        for t0 in range(0, xyz_frames.shape[0], chunk):
            frames = torch.as_tensor(np.asarray(xyz_frames[t0 : t0 + chunk], dtype=np.float32)).to(dev)
            B = frames.shape[0]
            Xb = torch.zeros((B, na, 3), dtype=torch.float32, device=dev)
            Xb[:, 1 : n + 1] = frames
            z = predictor.model(Xb, ids.expand(B, *ids.shape), q.expand(B, *q.shape),
                                M.expand(B, *M.shape), am.expand(B, na), nr=nr)
            probs.append(torch.sigmoid(z.to(torch.float32))[:, :n_res])
    return torch.cat(probs).cpu().numpy()


def interface_labels_from_reference(ref_subunits, receptor_chains, r_thr=5.0, device=None):
    """Ground-truth per-residue interface labels of the receptor from the
    bound complex (reference nb cell 6 via extract_all_contacts, on
    `device`; None means the GPU)."""
    from ..structure import concatenate_chains
    from ..topology import extract_all_contacts

    contacts = extract_all_contacts(ref_subunits, r_thr, device=device)
    rec = {c: ref_subunits[c] for c in receptor_chains}
    rec_merged = concatenate_chains(rec)
    resids = rec_merged["resid"]
    labels = np.zeros(np.unique(resids).shape[0], dtype=bool)

    offset = 0
    for c in receptor_chains:
        n_c = ref_subunits[c]["xyz"].shape[0]
        for other, data in contacts.get(c, {}).items():
            if other in receptor_chains:
                continue
            ids_c = data["ids"][:, 0] + offset
            rids = np.unique(resids[ids_c])
            labels[np.searchsorted(np.unique(resids), rids)] = True
        offset += n_c
    return labels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("traj", help="multi-model PDB trajectory of the receptor")
    parser.add_argument("--ref", required=True, help="bound reference complex PDB")
    parser.add_argument("--receptor-chains", default=None,
                        help="comma list of receptor chain names in the reference (default: chains present in the trajectory)")
    parser.add_argument("--every", type=int, default=100, help="use every k-th frame")
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--class-index", type=int, default=0, help="interface class (0=protein)")
    parser.add_argument("--out", default="md_results.csv")
    add_weight_args(parser)
    args = parser.parse_args(argv)

    from ..infer import Predictor
    from ..io import read_pdb, read_traj_pdb
    from ..metrics import _auc
    from ..structure import clean_structure, preprocess_structure
    from .apply_model import load_weights

    cfg, sd = load_weights(parser, args)
    pred = Predictor(cfg, sd, device=args.device)

    structure, frames = read_traj_pdb(args.traj)
    # apply the cleaning mask to the FRAMES too, so coordinates stay
    # aligned with the cleaned topology (waters/hydrogens dropped)
    keep = (
        (structure["resname"] != "HOH")
        & (structure["resname"] != "DOD")
        & (structure["element"] != "H")
        & (structure["element"] != "D")
    )
    frames = frames[:: args.every][:, keep]
    structure = clean_structure(structure)
    if structure["xyz"].shape[0] != frames.shape[1]:
        raise SystemExit(f"cleaned topology has {structure['xyz'].shape[0]} atoms but the "
                         f"frames have {frames.shape[1]}")

    ref_subunits = preprocess_structure(read_pdb(args.ref))
    if args.receptor_chains:
        receptor_chains = [c if ":" in c else f"{c}:0" for c in args.receptor_chains.split(",")]
    else:
        traj_chains = {c.split(":")[0] for c in np.unique(structure["chain_name"])}
        receptor_chains = [c for c in ref_subunits if c.split(":")[0] in traj_chains]
    y = interface_labels_from_reference(ref_subunits, receptor_chains, device=pred.device)

    probs = predict_trajectory(pred, structure, frames, chunk=args.chunk)

    if probs.shape[1] != len(y):
        raise SystemExit(
            f"trajectory has {probs.shape[1]} residues but the reference "
            f"receptor has {len(y)}; positional scoring would be misaligned."
            " Pass --receptor-chains matching the trajectory, or renumber"
            " the inputs (see pesto_tpu_torch.traj.match for sequence alignment)."
        )
    rows = []
    for t in range(probs.shape[0]):
        p = probs[t, :, args.class_index]
        n = len(y)
        auc = float(_auc(y, p)) if 0 < y.sum() < n else float("nan")
        rows.append((t * args.every, auc))
        print(f"frame {t * args.every}: AUC={auc:.4f}")

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "auc"])
        w.writerows(rows)
    aucs = np.array([a for _, a in rows])
    print(f"mean AUC over {len(rows)} frames: {np.nanmean(aucs):.4f}")


if __name__ == "__main__":
    main()
