"""CPU tests of the dimer's cell `x41_pairs`: the reference against the
port, the costs by hand, the cell by name, and runs driven with the timed
path broken. Run from the root of the repository:

    python -m pytest h100bench/tests/test_pairs_cell.py -q

Tests marked `chip` need the card and skip elsewhere.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from h100bench import harness, structures
from h100bench.reference import cross as rc
from h100bench.reference import pesto as ref

HERE = harness.HERE
CELL = "x41_pairs"
SEED = 2**31 + 91
TINY = dict(pool=8, pairs=4, per_call=2, check_sample=3,
            residues={"median": 60, "sigma": 0.3, "min": 50, "max": 90})


def tiny_cell():
    """The cell at a size a CPU test holds: two layers (nn 8 and 64) and a
    handful of small chains."""
    cell = harness.find_cell(harness.load_spec(), CELL)
    return dataclasses.replace(cell, config=dict(cell.config, nn=[8, 64]), mix=dict(cell.mix, **TINY))


def drive(capsys, seconds=2.0, trace=0):
    """A CPU run of the tiny cell through run.py's own execution; returns
    its result line."""
    sys.path.insert(0, HERE)
    import run as run_py

    sys.path.remove(HERE)
    args = argparse.Namespace(seed=SEED, seconds=seconds, trace=trace)
    assert run_py.execute(tiny_cell(), args, harness.process_start(), "cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_ids(X):
    from pesto_tpu_torch.ops.knn import knn_ids

    n = len(X)
    Xp = torch.zeros(1, n + 1, 3)
    Xp[0, 1:] = torch.as_tensor(X)
    am = torch.zeros(1, n + 1)
    am[0, 1:] = 1
    return knn_ids(Xp, am)[0][0, 1:].long() - 1


def test_reference_matches_the_port_on_the_cpu():
    """predict_pairs against the reference on seeded weights, with the
    port's own neighbours (this holds the model, not the kNN): 2e-6 on the
    probabilities, float32 sums in another order."""
    from pesto_tpu_torch.infer import Predictor

    from h100bench import common

    cfg = dict(harness.load_json("configs", "pesto_cross_i_v4_1.json"), nn=[8, 64, 16])
    sd = rc.make_weights(cfg, SEED, "cpu")
    pred = Predictor(common.program_config(cfg), {k: v.clone() for k, v in sd.items()}, device="cpu")
    recs = structures.make_records(9, 3, 60, 0.3, 50, 100)
    pairs = [(recs[0], recs[1]), (recs[2], recs[0])]
    model = rc.CrossModel(cfg)
    model.load_state_dict(sd)

    def side(rec):
        return rc.side(model, rec["xyz"], _port_ids(rec["xyz"]), ref.features(rec, cfg), *ref.residues(rec), "cpu")

    for pair, got in zip(pairs, pred.predict_pairs(pairs)):
        with torch.no_grad():
            want = [torch.sigmoid(z).numpy() for z in model(*(side(r) for r in pair))]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() < 2e-6
            assert w.std() > 1e-2  # the answers depend on the input
    # a chain's answer depends on its partner
    a0 = pred.predict_pairs(pairs)
    assert np.abs(a0[0][0] - a0[1][1]).max() > 1e-4


def test_cross_costs_match_a_hand_count():
    ca = harness.load_module("costs", "cross_attn")
    cf = harness.load_module("costs", "cross_forward")
    pf = harness.load_module("costs", "pesto_forward")
    S, cNh, cNk, n_a, n_b = 8, 2, 3, 11, 7
    # per (query atom, head, partner atom): cNk for the logit, S for the
    # values, both directions, 2 operations a multiply-add
    flops, nbytes = ca.cost(n_a, n_b, S, cNh, cNk)
    assert flops == 2 * (n_a * n_b + n_b * n_a) * cNh * (cNk + S) == 6776
    assert nbytes == 4 * (n_a + n_b) * (cNh * cNk + cNk + S + cNh * S)
    cfg = dict(Ns=S, Nh=2, Nk=3, nn=[8, 16], em_n0=30, em_n1=S, em_single=False, spl_n0=S, spl_n1=S,
               spl_nh=4, dm_n1=S, dm_n2=5, dm_single=False, cross={"cNh": cNh, "cNk": cNk})
    mlps = ((2 * S * S + S * S + S * cNk * cNh) + (2 * S * S + S * S + S * cNk)
            + (2 * S * S + S * S + S * S) + ((S + cNh * S) * S + S * S + S * S))
    want = (pf.flops(cfg, n_a, 3) + pf.flops(cfg, n_b, 2) + 2 * (n_a + n_b) * 2 * mlps + 2 * flops)
    assert cf.flops(cfg, n_a, 3, n_b, 2) == want


def test_the_cell_is_found_by_name():
    spec = harness.load_spec()
    cell = harness.find_cell(spec, CELL)
    assert cell.chips == 1 and cell.mix["driver"] == "predict_pairs"
    assert cell.config["cross"] == {"cNh": 2, "cNk": 3} and len(cell.config["nn"]) == 32
    assert [m["name"] for m in cell.end_to_end] == ["scan_atoms_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "cross_attn_roofline.pairs", "edge_fwd_roofline.pairs", "mfu.pairs", "idle_share.pairs",
        "predict_pairs.real_atom_share.pairs"}
    assert set(cell.limits) == {"answer_error_ratio"}
    # the cells that were there see none of it
    for name in ("v41_scan", "v30_scan"):
        assert not any(m["name"].endswith(".pairs") for m in harness.find_cell(spec, name).per_layer)


def test_a_program_without_predict_pairs_exits_at_once(monkeypatch, capsys):
    from pesto_tpu_torch.infer import Predictor

    monkeypatch.delattr(Predictor, "predict_pairs")
    with pytest.raises(SystemExit) as e:
        drive(capsys)
    assert e.value.code not in (0, None)


def _alter_largest_pair(monkeypatch):
    """predict_pairs hands back the largest pair's first chain with its
    residues in reverse order (an answer altered where it is produced)."""
    from pesto_tpu_torch.infer import Predictor

    orig = Predictor.predict_pairs

    def altered(self, pairs, *a, **kw):
        out = orig(self, pairs, *a, **kw)
        i = max(range(len(pairs)), key=lambda j: len(pairs[j][0]["xyz"]) * len(pairs[j][1]["xyz"]))
        out[i] = (out[i][0][::-1].copy(), out[i][1])
        return out

    monkeypatch.setattr(Predictor, "predict_pairs", altered)


def test_an_altered_answer_makes_the_run_incorrect(monkeypatch, capsys):
    sound = drive(capsys)
    assert sound["correct"], sound["checks"]
    assert list(sound)[-1] == "checks" and sound["failed"] == 0 and sound["attempted"] > 0
    assert set(sound["metrics"]) == {"scan_atoms_per_s", "setup_s"}
    _alter_largest_pair(monkeypatch)
    broken = drive(capsys)
    assert not broken["correct"], broken["checks"]


def test_a_traced_run_reports_the_per_layer_metrics(capsys):
    line = drive(capsys, seconds=12.0, trace=1)
    # no device on the CPU: the device-trace readers find nothing
    assert set(line["metrics"]) == {"mfu.pairs", "predict_pairs.real_atom_share.pairs"}
    assert 0 < line["metrics"]["predict_pairs.real_atom_share.pairs"]["value"] < 100
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.chip
def test_the_control_fails_on_the_chip():
    """The control (the reference in TF32) at the cell's own size reads
    over the limit on three seeds, and the program under it."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    cell = harness.find_cell(harness.load_spec(), CELL)
    driver = harness.load_module("drivers", cell.mix["driver"])
    for seed in (2**31 + 15, 2**31 + 16, 2**31 + 17):
        run = driver.run(cell, dict(seed=seed, seconds=4.0, trace=False, device="cuda",
                                    t0=harness.process_start(), control=True))
        assert run.correct, run.checks
        r = run.extra["readings"]
        failed = [n for n, lim in cell.limits.items() if r[f"{n}.control"] > lim["limit"]]
        assert failed, r
