"""The port's batched inference on the CPU against the JAX package's:
BatchEncoder's buffers, the Morton order, Predictor.predict_batch and
predict_pdb_files with the same weights, the per-item degradation of a
batch and of a folder, the buffer rotation under a deep pipeline, warmup,
the CLI's skip path and its training-checkpoint input, and the launch
counters under threads."""

import os
import pathlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import pesto_tpu.batching as jax_batching
import pesto_tpu_torch.models.config
from pesto_tpu.infer import Predictor as JaxPredictor
from pesto_tpu.models import get_config as jax_config
from pesto_tpu.spatial import morton_order as jax_morton_order
from pesto_tpu_torch import batching
from pesto_tpu_torch.apps import apply_model
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.io import read_structure, save_pdb
from pesto_tpu_torch.models import get_config
from pesto_tpu_torch.ops import _build
from pesto_tpu_torch.ops import edge_attention as ea
from pesto_tpu_torch.ops import knn
from pesto_tpu_torch.port import state_dict_from_jax_params
from pesto_tpu_torch.spatial import morton_order
from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure, split_by_chain
from pesto_tpu_torch.synthetic import random_structure_arrays, random_structure_record

from tests.test_torch_model import numpy_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "goldens" / "1OL5_A_i0.pdb")
PROB_ATOL = 1e-5


def _two_layers(cfg):
    # the first (8 neighbours) and the last of the 64-neighbour group
    return cfg.replace(layers=(cfg.layers[0], cfg.layers[12]))


@pytest.fixture(scope="module")
def model():
    jcfg = _two_layers(jax_config("i_v4_0", remat=False))
    params = numpy_params(jcfg, seed=6)
    cfg = _two_layers(get_config("i_v4_0"))
    return jcfg, params, cfg, state_dict_from_jax_params(params, cfg)


@pytest.fixture(scope="module")
def pred(model):
    return Predictor(model[2], model[3], device="cpu")


def _records():
    """Mixed sizes: n <= 64 (left unsorted), and several per bucket."""
    sizes = (40, 300, 700, 650, 120, 900)
    return [random_structure_record(n_atoms=n, n_res=max(n // 8, 3), seed=20 + i)
            for i, n in enumerate(sizes)]


def _items(compact):
    out = []
    for i, n in enumerate((40, 64, 65, 300, 700)):
        X, q, M = random_structure_arrays(n_atoms=n, n_res=max(n // 8, 3), seed=i)
        out.append((X, np.argmax(q, 1).astype(np.int32), np.argmax(M, 1).astype(np.int32), M.shape[1])
                   if compact else (X, q, M))
    return out


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("spatial_sort", [False, True])
def test_batch_encoder_buffers_equal_jax(compact, spatial_sort):
    """Equal bit for bit, the first time and after the rotation reuses a
    buffer set that held larger structures."""
    enc, jenc = batching.BatchEncoder(2, n_sets=2), jax_batching.BatchEncoder(2, n_sets=2)
    try:
        items = _items(compact)
        for batch in (items, items[::-1], [items[0]] * 5):
            kw = dict(na=1024, nr=128, spatial_sort=spatial_sort)
            got, want = enc.encode(batch, **kw), jenc.encode(batch, **kw, n_features=30)
            # the port fills no ids and no res_mask: a chunk computes its
            # kNN on the device and takes nr from its bucket
            assert got.ids_topk is None and got.res_mask is None
            for f in ("X", "q", "M", "atom_mask"):
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    finally:
        enc.close()
        jenc.close()


def test_batch_encoder_refills_a_set_only_after_its_copy(monkeypatch):
    """The sets of a signature rotate; a set is refilled only after the
    event of the copy out of it (here a stand-in), and the least recently
    used signature goes once there are more than MAX_BATCH_SHAPES, after
    its copies."""

    class Copy:  # stands in for the CUDA event recorded after a copy
        waits = 0

        def synchronize(self):
            Copy.waits += 1

    monkeypatch.setattr(batching, "MAX_BATCH_SHAPES", 2)
    enc = batching.BatchEncoder(2, n_sets=2)
    try:
        items, kw = _items(True), dict(na=1024, nr=128)
        key = (len(items), 1024, 128, True, ())
        first = enc.encode(items, **kw, device="cpu")  # tensors aliasing set 0
        assert first.X.data_ptr() == enc._sigs[key]["sets"][0]["np"]["X"].ctypes.data
        enc._sigs[key]["sets"][0]["ready"] = Copy()
        second = enc.encode(items, **kw)
        assert Copy.waits == 0 and second.X.ctypes.data != first.X.data_ptr()
        third = enc.encode(items, **kw)
        assert Copy.waits == 1 and third.X.ctypes.data == first.X.data_ptr()
        enc._sigs[key]["sets"][1]["ready"] = Copy()
        enc.encode(items[:2], **kw)
        enc.encode(items[:3], **kw)  # a third signature: the first goes
        assert key not in enc._sigs and len(enc._sigs) == 2 and Copy.waits == 2
    finally:
        enc.close()


def test_batch_encoder_rejects_over_bucket_items():
    enc = batching.BatchEncoder(2)
    try:
        with pytest.raises(ValueError, match="exceeds bucket"):
            enc.encode(_items(False)[-1:], na=512, nr=128)
    finally:
        enc.close()


def test_morton_order_equals_jax():
    rng = np.random.RandomState(0)
    clouds = [rng.rand(n, 3).astype(np.float32) * 40 for n in (1, 5, 65, 1000)]
    clouds.append(np.repeat(clouds[2][:7], 3, axis=0))  # duplicate points
    clouds.append(np.zeros((10, 3), np.float32))  # zero span
    for X in clouds:
        np.testing.assert_array_equal(morton_order(X), jax_morton_order(X))


def test_predict_batch_equals_jax_and_predict_structure(model, pred, record_property):
    jcfg, params, _, _ = model
    golden = concatenate_chains(preprocess_structure(read_structure(GOLDEN)))
    recs = [golden] + _records()
    got = pred.predict_batch(recs, atoms_per_call=2048)
    want = JaxPredictor(jcfg, params).predict_batch(recs, atoms_per_call=2048)
    worst_jax = worst_single = 0.0
    for s, g, w in zip(recs, got, want):
        single = pred.predict_structure(s)
        assert g.shape == w.shape == single.shape == (len(np.unique(s["resid"])), 5)
        np.testing.assert_allclose(g, w, atol=PROB_ATOL, rtol=0)
        np.testing.assert_allclose(g, single, atol=PROB_ATOL, rtol=0)
        worst_jax = max(worst_jax, float(np.abs(g - w).max()))
        worst_single = max(worst_single, float(np.abs(g - single).max()))
    record_property("max_abs_dev_jax", worst_jax)
    record_property("max_abs_dev_predict_structure", worst_single)


def test_topology_of_a_structure_does_not_depend_on_its_batch():
    """The kNN input (centred coordinates and |x|^2) and the neighbour ids
    of a structure are bit for bit the same alone and in a batch of others,
    so that predict_batch's kNN agrees with predict_structure's even on
    near-ties of the Gram form."""
    clouds = [random_structure_arrays(n_atoms=n, n_res=n // 8, seed=40 + i)[0]
              for i, n in enumerate((1000, 600, 1023, 64))]
    X = np.zeros((len(clouds), 1024, 3), np.float32)
    am = np.zeros((len(clouds), 1024), np.float32)
    for b, c in enumerate(clouds):
        X[b, 1 : len(c) + 1], am[b, 1 : len(c) + 1] = c, 1.0
    X, am = torch.tensor(X), torch.tensor(am)
    batched = knn.center_coords(X, am)
    ids_b, ok_b = knn.knn_ids(X, am)
    for b in range(len(clouds)):
        assert torch.equal(knn.center_coords(X[b : b + 1], am[b : b + 1])[0], batched[b])
        ids, ok = knn.knn_ids(X[b : b + 1], am[b : b + 1])
        assert torch.equal(ids[0], ids_b[b]) and torch.equal(ok[0], ok_b[b])


def test_predict_batch_isolates_oversize_structures(pred, monkeypatch, capsys):
    """The ladder is shrunk so that a 600-atom record is over the largest
    bucket."""
    monkeypatch.setattr(batching, "ATOM_BUCKETS", (256, 512))
    ok = random_structure_record(n_atoms=40, n_res=8, seed=0)
    big = random_structure_record(n_atoms=600, n_res=60, seed=1)
    out = pred.predict_batch([ok, big, ok])
    assert out[0] is not None and out[2] is not None and out[1] is None
    np.testing.assert_array_equal(out[0], out[2])
    assert "SizeError: structure 1" in capsys.readouterr().err


def test_predict_batch_isolates_malformed_structures(pred, capsys):
    ok = random_structure_record(n_atoms=40, n_res=8, seed=0)
    empty = {k: np.asarray(v)[:0] for k, v in random_structure_record(n_atoms=4, n_res=2, seed=1).items()}
    out = pred.predict_batch([ok, empty, ok])
    assert out[0] is not None and out[2] is not None and out[1] is None
    assert "EncodeError: structure 1" in capsys.readouterr().err


def test_predict_batch_concurrent_calls_are_safe(pred):
    recs_a = [random_structure_record(n_atoms=40, n_res=8, seed=i) for i in range(4)]
    recs_b = [random_structure_record(n_atoms=300, n_res=30, seed=10 + i) for i in range(4)]
    want_a, want_b = pred.predict_batch(recs_a), pred.predict_batch(recs_b)
    with ThreadPoolExecutor(2) as ex:
        fa, fb = ex.submit(pred.predict_batch, recs_a), ex.submit(pred.predict_batch, recs_b)
        got_a, got_b = fa.result(timeout=120), fb.result(timeout=120)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_predict_batch_deep_pipeline_buffer_rotation(pred, monkeypatch):
    """One structure per chunk, two chunks in flight: each chunk's inputs
    (on the CPU, views of the encoder's buffers) must stay unchanged while
    the next `depth` chunks encode, which takes depth + 1 buffer sets."""
    depth = 2
    recs = [random_structure_record(n_atoms=60 + 3 * i, n_res=8, seed=i) for i in range(8)]
    want = [pred.predict_structure(r) for r in recs]
    launched = []
    chunk_program = pred._forward

    def checked(*sides):
        ((X, q, M, am, nr),) = sides
        for inputs, copies in launched[-depth:]:  # possibly still in flight
            assert all(torch.equal(a, b) for a, b in zip(inputs, copies)), \
                "a chunk in flight had its buffers overwritten"
        launched.append(((X, q, M, am), tuple(t.clone() for t in (X, q, M, am))))
        return chunk_program(*sides)

    monkeypatch.setattr(pred, "_forward", checked)
    got = pred.predict_batch(recs, atoms_per_call=64, pipeline_depth=depth)
    assert len(launched) == len(recs)
    enc = pred._enc_pool.get_nowait()  # checked back into the idle pool
    assert enc.n_sets >= depth + 1
    pred._enc_pool.put(enc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PROB_ATOL, rtol=0)


def _write_pdbs(tmp_path):
    paths = []
    for i, (na, nr) in enumerate([(40, 8), (56, 10), (48, 9)]):
        p = str(tmp_path / f"s{i}.pdb")
        save_pdb(split_by_chain(random_structure_record(n_atoms=na, n_res=nr, seed=10 + i)), p)
        paths.append(p)
    bad = str(tmp_path / "not_a_structure.pdb")
    pathlib.Path(bad).write_text("this is not a pdb file\n")
    paths.insert(1, bad)
    return paths


def test_predict_pdb_files_threaded_parse_matches_serial(model, pred, tmp_path, capsys):
    paths = _write_pdbs(tmp_path)
    structs, probs = pred.predict_pdb_files(paths, num_threads=4)
    assert len(structs) == len(probs) == len(paths)
    assert structs[1] is None and probs[1] is None
    assert "ReadError" in capsys.readouterr().err
    good = [paths[0], paths[2], paths[3]]
    serial = [concatenate_chains(preprocess_structure(read_structure(p))) for p in good]
    want = pred.predict_batch(serial)
    jcfg, params, _, _ = model
    _, want_jax = JaxPredictor(jcfg, params).predict_pdb_files(paths, num_threads=4)
    for g, w, wj in zip([probs[0], probs[2], probs[3]], want, [want_jax[0], want_jax[2], want_jax[3]]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, wj, atol=PROB_ATOL, rtol=0)


def _bad_folder(tmp_path):
    """1OL5, an unreadable file and a structure over the (shrunk) ladder."""
    folder = tmp_path / "in"
    folder.mkdir()
    (folder / "1OL5_A.pdb").write_text(pathlib.Path(GOLDEN).read_text())
    (folder / "broken.pdb").write_text("this is not a pdb file\n")
    save_pdb(split_by_chain(random_structure_record(n_atoms=5000, n_res=600, seed=3)),
             str(folder / "huge.pdb"))
    return folder


def test_predict_pdb_files_degrades_per_item(pred, tmp_path, monkeypatch, capsys):
    """A folder with an unreadable file and an over-bucket structure gives
    one None per bad item and 1OL5's probabilities all the same."""
    monkeypatch.setattr(batching, "ATOM_BUCKETS", (256, 512, 1024, 2048, 4096))
    folder = _bad_folder(tmp_path)
    paths = [str(folder / f) for f in ("1OL5_A.pdb", "broken.pdb", "huge.pdb")]
    structs, probs = pred.predict_pdb_files(paths)
    assert structs[1] is None and probs[1] is None
    assert structs[2] is not None and structs[2]["xyz"].shape[0] == 5000 and probs[2] is None
    assert probs[0].shape == (len(np.unique(structs[0]["resid"])), 5)
    np.testing.assert_allclose(probs[0], pred.predict_structure(structs[0]), atol=PROB_ATOL, rtol=0)
    err = capsys.readouterr().err
    assert "ReadError" in err and "SizeError" in err


def test_apply_model_skips_bad_files(model, tmp_path, monkeypatch, capsys):
    """The CLI prints ReadError and SkipError and still writes 1OL5's five
    files, from a reference-layout checkpoint and from a training
    checkpoint directory with the same weights."""
    from pesto_tpu_torch.train import create_train_state
    from pesto_tpu_torch.train.checkpoint import AsyncCheckpointer

    _, _, cfg, sd = model
    monkeypatch.setattr(batching, "ATOM_BUCKETS", (256, 512, 1024, 2048, 4096))
    monkeypatch.setattr(pesto_tpu_torch.models.config, "get_config", lambda name, **kw: cfg)
    folder = _bad_folder(tmp_path)
    ckpt = str(tmp_path / "model.pt")
    torch.save(sd, ckpt)
    train_dir = str(tmp_path / "train_ckpt")
    writer = AsyncCheckpointer()
    writer.save(train_dir, create_train_state(cfg, state_dict=sd, device="cpu"))
    writer.close()

    outs = {}
    for name, source in (("ckpt", ["--ckpt", ckpt]), ("train", ["--train-ckpt", train_dir])):
        outs[name] = tmp_path / f"out_{name}"
        apply_model.main([str(folder), "--out", str(outs[name]), *source, "--model", "i_v4_0",
                          "--device", "cpu"])
        err = capsys.readouterr().err
        assert "ReadError" in err and "broken.pdb" in err
        assert "SkipError" in err and "huge.pdb" in err
        assert sorted(os.listdir(outs[name])) == [f"1OL5_A_i{k}.pdb" for k in range(5)]
    for k in range(5):
        f = f"1OL5_A_i{k}.pdb"
        assert (outs["ckpt"] / f).read_bytes() == (outs["train"] / f).read_bytes()
    with pytest.raises(SystemExit):
        apply_model.main([str(folder), "--train-ckpt", str(tmp_path / "empty"), "--device", "cpu"])


def test_warmup_runs(pred):
    calls = pred.stage_ms["batch_calls"]
    pred.warmup(buckets=[(256, 32), (512, 64)], batch_sizes=(1, 2))
    assert pred.stage_ms["batch_calls"] == calls  # warmup is not a predict_batch call


def test_launch_counters_under_threads():
    """Eight threads adding to both counters lose no increment, and every
    kernel wrapper counts through the locked helper."""
    kernels = (knn.knn_kernel, ea.edge_attention_kernel)
    before = [k.launches for k in kernels]
    n, workers = 3000, 8
    start = threading.Barrier(workers)

    def hammer():
        start.wait(timeout=30)
        for _ in range(n):
            for k in kernels:
                _build.count_launch(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [k.launches - b for k, b in zip(kernels, before)] == [n * workers] * 2
    finally:
        sys.setswitchinterval(old)
        for k, b in zip(kernels, before):
            k.launches = b
    for src in (ROOT / "pesto_tpu_torch" / "ops").glob("*.py"):
        if src.name != "_build.py":  # the helper itself
            assert ".launches += 1" not in src.read_text(), src.name
