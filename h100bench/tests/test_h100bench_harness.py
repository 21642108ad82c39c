"""CPU tests of the benchmark: the generator, the costs, the reference
against the port, the registries by name, the import isolation, and runs
driven with the timed path broken. Run from the root of the repository:

    python -m pytest h100bench/tests -q

Tests marked `chip` need the card and skip elsewhere.
"""

import argparse
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench import harness, structures
from h100bench.reference import knn as ref_knn
from h100bench.reference import pdb as ref_pdb
from h100bench.reference import pesto as ref
from h100bench.reference import train as ref_train

HERE = harness.HERE
ROOT = harness.ROOT
LAW = {"median": 60, "sigma": 0.3, "min": 50, "max": 90}
SEED = 2**31 + 77


# cells whose drivers, metrics and limits stay under h100bench/ while
# BENCHMARK.json leaves them out (PERF.md, Open questions): the tests still
# drive them
LATER = {
    "workloads": [
        {"name": "v41_train", "config": "pesto_i_v4_1", "traffic": "train_job", "chips": 1, "why": "training"},
        {"name": "v41_serve", "config": "pesto_i_v4_1", "traffic": "web_requests", "chips": 1, "why": "serving"}],
    "end_to_end": [
        {"name": "train_atoms_per_s", "unit": "atoms/s", "workloads": ["v41_train"]},
        {"name": "serve_p95_ms", "unit": "ms", "workloads": ["v41_serve"]}],
    "per_layer": [
        {"name": n, "unit": u, "moves": "train_atoms_per_s", "workloads": ["v41_train"]}
        for n, u in (("loader.wait_ms", "ms"), ("train_step.backward_ms", "ms"), ("train_step.optimizer_ms", "ms"),
                     ("mfu.train", "%"), ("edge_bwd_roofline.train", "%"), ("idle_share.train", "%"))] + [
        {"name": n, "unit": u, "moves": "serve_p95_ms", "workloads": ["v41_serve"]}
        for n, u in (("serve.parse_ms", "ms"), ("serve.queue_wait_ms", "ms"), ("idle_share.serve", "%"))],
}


def full_spec():
    spec = harness.load_spec()
    for key, entries in LATER.items():
        spec[key] = spec[key] + entries
    return spec


def tiny_cell(name, **mix):
    """The cell at a size a CPU test holds: two layers (nn 8 and 64) and a
    handful of small structures."""
    cell = harness.find_cell(full_spec(), name)
    return dataclasses.replace(cell, config=dict(cell.config, nn=[8, 64]), mix=dict(cell.mix, **mix))


TINY = {
    "v41_scan": dict(pool=8, per_call=4, residues=LAW, check_sample=3),
    "v30_scan": dict(pool=8, per_call=4, residues=LAW, check_sample=3),
    "v41_train": dict(items=12, residues=LAW, max_atoms=1000, traced_steps=1),
    "v41_serve": dict(rate_per_s=4.0, residues=LAW, warmup_requests=2, warmup_burst=2, grace_s=20,
                      check_sample=2),
}


def drive(name, seconds=2.0, trace=0, capsys=None):
    """A CPU run of the tiny cell through run.py's own execution; returns
    its result line."""
    sys.path.insert(0, HERE)
    import run as run_py

    sys.path.remove(HERE)
    args = argparse.Namespace(seed=SEED, seconds=seconds, trace=trace)
    assert run_py.execute(tiny_cell(name, **TINY[name]), args, harness.process_start(), "cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------- generator


def test_generator_is_deterministic_by_seed():
    a = structures.make_records(SEED, 6, 400, 0.7, 50, 4000)
    b = structures.make_records(SEED, 6, 400, 0.7, 50, 4000)
    c = structures.make_records(SEED + 1, 6, 400, 0.7, 50, 4000)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert any(len(x["xyz"]) != len(y["xyz"]) or not np.array_equal(x["xyz"], y["xyz"]) for x, y in zip(a, c))
    # every seed gets the same residue counts, in another order
    counts = lambda recs: sorted(int(r["resid"].max()) for r in recs)  # noqa: E731
    assert counts(a) == counts(c) == sorted(structures.size_law(6, 400, 0.7, 50, 4000).tolist())


def test_size_law_and_element_mix():
    sizes = structures.size_law(512, 400, 0.7, 50, 4000)
    assert sizes.min() >= 50 and sizes.max() <= 4000
    assert abs(np.median(sizes) - 400) <= 2
    assert abs(np.std(np.log(sizes)) - 0.7) < 0.03
    recs = structures.make_records(5, 64, 400, 0.7, 50, 4000)
    res = np.concatenate([r["resname"][r["name"] == "CA"] for r in recs])
    freq = np.array([structures.AA_FREQ[n] for n in structures.RESNAMES])
    got = np.array([(res == n).mean() for n in structures.RESNAMES])
    assert np.abs(got - freq / freq.sum()).max() < 0.01
    atoms = sum(len(r["xyz"]) for r in recs) / len(res)
    assert abs(atoms - 7.8) < 0.1 and abs(structures.MEAN_ATOMS_PER_RES - 7.8) < 0.05
    for r in recs[:4]:
        assert np.array_equal(r["element"], np.array([n[0] for n in r["name"]]))
        assert set(np.unique(r["element"])) <= {"C", "N", "O", "S"}
        n_res = int(r["resid"].max())
        radius = (3 * len(r["xyz"]) / (4 * np.pi * structures.DENSITY)) ** (1 / 3)
        ca = r["xyz"][r["name"] == "CA"]
        snap = 3 ** 0.5 / structures.GRID  # each atom moved at most this far onto the grid
        assert len(ca) == n_res and np.linalg.norm(ca, axis=1).max() <= radius + 10.0
        steps = np.linalg.norm(np.diff(ca, axis=0), axis=1)
        assert np.all(np.abs(steps - structures.STEP) <= snap + 1e-6)
        assert np.array_equal(r["xyz"] * structures.GRID, np.rint(r["xyz"] * structures.GRID))
        assert not r["xyz"].astype(np.float64).sum(0).any()


def test_pdb_text_reads_back_in_both_readers():
    from pesto_tpu_torch.io import read_pdb
    from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure

    recs, kinds = structures.make_records(3, 2, 300, 0.3, 50, 4000, with_kinds=True)
    for rec, kind in zip(recs, kinds):
        text = structures.pdb_text(rec, kind)
        mine = ref_pdb.read(text)
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"h100bench_{os.getpid()}.pdb")
        with open(path, "wb") as f:
            f.write(text)
        try:
            port = concatenate_chains(preprocess_structure(read_pdb(path)))
        finally:
            os.unlink(path)
        for got in (mine, port):
            assert np.abs(got["xyz"] - rec["xyz"]).max() <= 5e-4
            for k in ("name", "element", "resname", "resid"):
                assert np.array_equal(np.asarray(got[k]), np.asarray(rec[k]))


# ---------------------------------------------------------------- costs


def test_edge_costs_match_a_hand_count():
    ef = harness.load_module("costs", "edge_fwd")
    eb = harness.load_module("costs", "edge_bwd")
    S, Nh, Nk, nn, n = 8, 2, 3, 4, 10
    per_edge = (3 * 3 * S                         # |p_m|, <p_n, r>, <p_m, r>
                + (4 * S + 1) * 4 * S             # first layers on the edge's own inputs
                + S * S + S * S + 2 * S * 2 * S   # second layers
                + S * Nk + S * 3 * Nk + 2 * S * 2 * S  # third layers
                + Nh * Nk + 3 * Nh * Nk           # logits
                + Nh * S + 3 * S + 3 * Nh * S + Nh + 3 * Nh * S)  # value sums
    assert per_edge == 2026 == ef.per_edge_macs(S, Nh, Nk)
    per_atom = 2 * S * 4 * S + 3 * Nh * S
    flops, nbytes = ef.cost(n, nn, S, Nh, Nk)
    assert flops == 2 * (n * nn * per_edge + n * per_atom)
    weights = (6 * S + 1) * 4 * S + 4 * S + 6 * S * S + 4 * S + 4 * S * Nk + 4 * S * S + 4 * Nk + 2 * S
    assert nbytes == 4 * (n * (4 * S + nn + 3 * nn + 2 * Nh * Nk) + weights) + 4 * n * nn + 4 * n * 4 * Nh * S
    bflops, bbytes = eb.cost(n, nn, S, Nh, Nk)
    assert bflops == 2 * flops
    assert bbytes == 2 * (nbytes - 4 * n * 4 * Nh * S) - 4 * n * nn + 4 * n * 4 * Nh * S


def test_model_cost_matches_a_hand_count():
    pf = harness.load_module("costs", "pesto_forward")
    ef = harness.load_module("costs", "edge_fwd")
    S, Nh, Nk, n, r = 8, 2, 3, 50, 7
    cfg = dict(Ns=S, Nh=Nh, Nk=Nk, nn=[8, 16], em_n0=30, em_n1=S, em_single=False, spl_n0=S, spl_n1=S,
               spl_nh=4, dm_n1=S, dm_n2=5, dm_single=False)
    embed = 30 * S + S * S + S * S
    layer = 3 * S + (2 * S * S + S * S + S * 2 * Nk * Nh) + (Nh * S * S + S * S + S * S) + 3 * Nh * S * S
    pool_atom = 3 * S + (2 * S * S + S * S + S * 8) + 4 * S * 4
    pool_res = (4 * S * S + S * S + S * S) + 3 * 4 * S * S + 3 * S + (2 * S * S + S * S + S * 5)
    want = sum(ef.cost(n, k, S, Nh, Nk)[0] for k in (8, 16)) + 2 * (
        n * (embed + 2 * layer + pool_atom) + r * pool_res)
    assert pf.flops(cfg, n, r) == want


# ---------------------------------------------------------------- the reference


def _port_ids(X):
    from pesto_tpu_torch.ops.knn import knn_ids

    n = len(X)
    Xp = torch.zeros(1, n + 1, 3)
    Xp[0, 1:] = torch.as_tensor(X)
    am = torch.zeros(1, n + 1)
    am[0, 1:] = 1
    return knn_ids(Xp, am)[0][0, 1:].long() - 1


@pytest.mark.parametrize("name", ["pesto_i_v4_1", "pesto_i_v3_0"])
def test_reference_matches_the_port_on_the_cpu(name):
    from pesto_tpu_torch.infer import Predictor

    from h100bench import common

    cfg = dict(harness.load_json("configs", f"{name}.json"), nn=[8, 64, 16])
    sd = ref.make_weights(cfg, SEED, "cpu")
    pred = Predictor(common.program_config(cfg), {k: v.clone() for k, v in sd.items()}, device="cpu")
    recs = structures.make_records(9, 3, 60, 0.3, 50, 100)
    model = ref.Model(cfg)
    model.load_state_dict(sd)
    for rec, got in zip(recs, pred.predict_batch(recs)):
        with torch.no_grad():
            # the port's own neighbours: this holds the model, not the kNN
            want = torch.sigmoid(ref.logits(model, rec, _port_ids(rec["xyz"]), "cpu")).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 2e-6
        assert want.std() > 1e-2  # the answers depend on the input


def test_reference_knn_is_exact():
    X = torch.from_numpy(structures.make_records(4, 1, 80, 0.1, 50, 100)[0]["xyz"])
    ids = ref_knn.knn(X, block=37)
    d = torch.cdist(X.double(), X.double())
    d.fill_diagonal_(float("inf"))
    want = torch.sort(d, dim=1, stable=True).indices[:, :64]
    assert torch.equal(ids, want)


def test_reference_train_step_matches_the_port_on_the_cpu():
    from pesto_tpu_torch.batching import pad_structure_arrays, stack_batch, to_device
    from pesto_tpu_torch.train.state import create_train_state
    from pesto_tpu_torch.train.step import make_train_step

    from h100bench import common

    cfg = dict(harness.load_json("configs", "pesto_i_v4_1.json"), nn=[8, 16])
    sd = ref.make_weights(cfg, SEED, "cpu")
    recs = structures.make_records(11, 2, 60, 0.1, 50, 100)
    recs = [r for r in recs if len(r["xyz"]) == len(recs[0]["xyz"])] or recs[:1]
    rng = np.random.default_rng(0)
    items = []
    for rec in recs:
        ids = ref_knn.knn(torch.from_numpy(rec["xyz"]), dtype=torch.float32)
        res, n_res = ref.residues(rec)
        y = (rng.random((n_res, 5)) < 0.2).astype(np.float32)
        items.append((rec["xyz"], ids.numpy(), ref.features(rec, cfg).numpy(), res.numpy(), n_res, y))
    padded = [pad_structure_arrays(X, q, (res[:, None] == np.arange(nr)).astype(np.float32), y=y,
                                   ids_topk_raw=ids, compact=True) for X, ids, q, res, nr, y in items]
    state = create_train_state(common.program_config(cfg), learning_rate=1e-3,
                               state_dict={k: v.clone() for k, v in sd.items()}, device="cpu")
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    state, out = make_train_step()(state, to_device(stack_batch(padded), "cpu"))
    losses, grads, change = ref_train.steps(cfg, sd, [list(items)], 1e-3, "cpu")
    assert abs(float(out["loss"]) - losses[0]) <= 1e-6 * abs(losses[0])
    gmed, cmed = np.median(list(grads.values())), np.median(list(change.values()))
    for k, p in state.model.named_parameters():
        g = float(p.grad.double().norm())
        assert abs(g - grads[k]) <= 1e-4 * max(grads[k], gmed), k
        if grads[k] >= 1e-3 * gmed:  # leaves that move by round-off alone are left out
            assert abs(float((p.detach() - start[k]).double().norm()) - change[k]) <= 1e-4 * max(change[k], cmed), k


# ---------------------------------------------------------------- the harness


def test_spec_names_and_files_follow_the_contract():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name_ok = lambda s: s and len(s) <= 64 and all(c.isascii() and (c.isalnum() or c in "_.-") for c in s)  # noqa: E731
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name_ok(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"])) and len(c["source"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        harness.find_cell(spec, w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name_ok(m["name"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["unit"]) <= 16 and all(c.isascii() and (c.isalnum() or c in "_/%.-") for c in m["unit"])
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_config_mix_driver_and_metric_are_found_by_name(tmp_path):
    """New files and entries only: a copy of the benchmark gains a config,
    a mix, a driver and a metric, and a cell that names them runs."""
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "h100bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    b = copy / "h100bench"
    cfg = json.loads((b / "configs" / "pesto_i_v4_1.json").read_text())
    (b / "configs" / "pesto_other.json").write_text(json.dumps(dict(cfg, name="pesto_other", nn=[8, 16])))
    (b / "traffic" / "echo_mix.json").write_text(json.dumps({"driver": "echo", "atoms": 123}))
    (b / "limits" / "other_echo.json").write_text(json.dumps({"echo_gap": {"limit": 1.0}}))
    (b / "drivers" / "echo.py").write_text(
        "from h100bench import harness\n"
        "def run(cell, ctx):\n"
        "    r = harness.Run(config=cell.config, attempted=1, window_s=1.0)\n"
        "    r.values.update(setup_s=0.5, echo_atoms_per_s=cell.mix['atoms'] * len(cell.config['nn']))\n"
        "    r.counters['echoed'] = 7\n"
        "    r.check('echo_gap', 0.0, cell.limits['echo_gap']['limit'])\n"
        "    return r\n")
    (b / "metrics" / "echo.count.py").write_text("def read(run):\n    return run.counters['echoed']\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="pesto_other", file="h100bench/configs/pesto_other.json"))
    spec["workloads"].append({"name": "other_echo", "config": "pesto_other", "traffic": "echo_mix", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"].append({"name": "echo_atoms_per_s", "unit": "atoms/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["other_echo"]})
    spec["per_layer"].append({"name": "echo.count", "unit": "1", "better": "higher", "source": "program_counter",
                              "layer": "echo", "moves": "echo_atoms_per_s", "workloads": ["other_echo"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    spec_h = __import__("importlib.util").util.spec_from_file_location("h100bench_copy_harness", b / "harness.py")
    h = __import__("importlib.util").util.module_from_spec(spec_h)
    spec_h.loader.exec_module(h)
    cell = h.find_cell(h.load_spec(str(copy)), "other_echo", root=str(copy))
    assert cell.config["nn"] == [8, 16] and cell.mix["atoms"] == 123
    run = h.load_module("drivers", cell.mix["driver"]).run(cell, {})
    dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    untraced = h.result_line(cell, run, False, dev)
    assert untraced["metrics"]["echo_atoms_per_s"]["value"] == 246.0 and untraced["correct"]
    assert h.result_line(cell, run, True, dev)["metrics"] == {"echo.count": {"value": 7.0, "unit": "1"}}
    assert list(untraced)[-1] == "checks"
    # the cells that were there see none of it
    assert not any(m["name"].startswith("echo") for m in h.find_cell(h.load_spec(str(copy)), "v41_scan",
                                                                        root=str(copy)).per_layer)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pesto_tpu_torch_fake.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pesto_tpu.fake", sys)
    assert harness.forbidden_modules() == ["pesto_tpu.fake"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                mods = set(_imports(os.path.join(dirpath, f)))
                assert not mods & set(harness.FORBIDDEN), (f, mods)
                if os.path.basename(dirpath) == "reference":
                    assert "pesto_tpu_torch" not in mods and "h100bench" not in mods, f


def test_a_run_loads_no_jax():
    """A whole CPU run in a fresh interpreter: run.py exits 3 if JAX or the
    JAX package was loaded."""
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "sys.modules['torch.utils.tensorboard'] = None\n"
            "from h100bench.tests.test_h100bench_harness import tiny_cell, TINY, SEED\n"
            "import argparse, run\n"
            "from h100bench import harness\n"
            "a = argparse.Namespace(seed=SEED, seconds=1.0, trace=0)\n"
            "sys.exit(run.execute(tiny_cell('v41_scan', **TINY['v41_scan']), a, harness.process_start(), 'cpu'))\n"
            % (ROOT, HERE))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}


def test_run_refuses_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, HERE)
    import run as run_py

    sys.path.remove(HERE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_py.main(["--workload", "v41_scan", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------- runs with the timed path broken


def _alter_largest_answer(monkeypatch):
    """predict_batch hands back the largest structure's answer with its
    residues in reverse order (an answer altered where it is produced)."""
    from pesto_tpu_torch.infer import Predictor

    orig = Predictor.predict_batch

    def altered(self, structures_, *a, **kw):
        out = orig(self, structures_, *a, **kw)
        i = max(range(len(structures_)), key=lambda j: len(structures_[j]["xyz"]))
        out[i] = out[i][::-1].copy()
        return out

    monkeypatch.setattr(Predictor, "predict_batch", altered)


@pytest.mark.parametrize("name", ["v41_scan", "v30_scan", "v41_serve"])
def test_an_altered_answer_makes_the_run_incorrect(name, monkeypatch, capsys):
    sound = drive(name, capsys=capsys)
    assert sound["correct"], sound["checks"]
    assert list(sound)[-1] == "checks" and sound["failed"] == 0 and sound["attempted"] > 0
    _alter_largest_answer(monkeypatch)
    broken = drive(name, capsys=capsys)
    assert not broken["correct"], broken["checks"]


def test_a_step_that_keeps_its_state_makes_the_run_incorrect(monkeypatch, capsys):
    from pesto_tpu_torch.train.state import TrainState

    sound = drive("v41_train", capsys=capsys)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: None)
    broken = drive("v41_train", capsys=capsys)
    assert not broken["correct"]
    # every leaf at or above the median reads 1, the ones below it their share of the median
    assert broken["checks"]["change_median_gap"]["value"] > 0.9


def test_half_the_batch_left_out_makes_the_run_incorrect(monkeypatch, capsys):
    from pesto_tpu_torch.train import step as step_mod

    orig = step_mod.masked_bce_with_pos_weight

    def half(z, y, res_mask, *a, **kw):
        keep = torch.zeros_like(res_mask)
        keep[..., ::2] = 1
        return orig(z, y, res_mask * keep, *a, **kw)

    monkeypatch.setattr(step_mod, "masked_bce_with_pos_weight", half)
    broken = drive("v41_train", capsys=capsys)
    assert not broken["correct"], broken["checks"]


def test_a_traced_run_reports_the_per_layer_metrics(capsys):
    line = drive("v41_scan", seconds=8.0, trace=1, capsys=capsys)
    assert set(line["metrics"]) == {"predict_batch.encode_ms", "mfu.scan"}  # no device on the CPU
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    line = drive("v41_train", seconds=8.0, trace=1, capsys=capsys)
    assert {"loader.wait_ms", "mfu.train"} <= set(line["metrics"])


# ---------------------------------------------------------------- on the chip


@pytest.mark.chip
@pytest.mark.parametrize("name", ["v41_scan", "v30_scan"])
def test_the_control_fails_on_the_chip(name):
    """The control (the reference in TF32) at the cell's own size reads
    over the limit on three seeds, and the program under it."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    cell = harness.find_cell(harness.load_spec(), name)
    driver = harness.load_module("drivers", cell.mix["driver"])
    for seed in (2**31 + 5, 2**31 + 6, 2**31 + 7):
        run = driver.run(cell, dict(seed=seed, seconds=4.0, trace=False, device="cuda",
                                    t0=harness.process_start(), control=True))
        assert run.correct, run.checks
        r = run.extra["readings"]
        failed = [n for n, lim in cell.limits.items() if r[f"{n}.control"] > lim["limit"]]
        assert failed, r
