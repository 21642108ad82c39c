"""One structure with its atoms sharded over devices, and data-parallel
serving, on the CPU, against the JAX package: the edge attention of a
shard (a table and an offset) against the TPU kernel in interpret mode;
the sharded forward on 2, 4 and 8 `cpu` shards against the port's
single-device forward and `pesto_tpu.parallel.make_sp_forward`;
`Predictor.predict_structure_sp` against `predict_structure` and JAX's;
and `predict_batch` over a 2-device mesh against one device and JAX's
mesh Predictor, with no collective."""

import jax
import numpy as np
import pytest
import torch

from pesto_tpu.infer import Predictor as JaxPredictor
from pesto_tpu.models import PestoModel as JaxModel
from pesto_tpu.models import get_config as jax_config
from pesto_tpu.parallel import make_mesh as jax_make_mesh
from pesto_tpu.parallel.sp import make_sp_forward as jax_sp_forward
from pesto_tpu.synthetic import random_padded_structure, random_structure_record
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.models import PestoModel, get_config
from pesto_tpu_torch.ops import edge_attention as ea
from pesto_tpu_torch.parallel import comm, make_mesh, make_sp_forward
from pesto_tpu_torch.port import state_dict_from_jax_params

from tests.test_torch_edge_attention import NH, NK, S, _block_diag, _inputs, _tpu_kernel
from tests.test_torch_model import numpy_params

LOGIT_ATOL = 2e-6       # JAX's own for its sharded forward (tests/test_sp.py:33-44)
SP_PROB_TOL = 2e-5      # JAX's own for predict_structure_sp (tests/test_serving_mesh.py:75-89)
DP_PROB_TOL = 1e-5      # JAX's own for mesh serving (tests/test_serving_mesh.py:37-54)
EDGE_TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_torch_edge_attention.py, fp32


def _four_layers(cfg):
    return cfg.replace(layers=cfg.layers[:4])  # one layer of each nn group


@pytest.fixture(scope="module")
def model():
    jcfg = _four_layers(jax_config("i_v4_0", remat=False))
    params = numpy_params(jcfg, seed=4)
    cfg = _four_layers(get_config("i_v4_0"))
    return jcfg, params, cfg, state_dict_from_jax_params(params, cfg)


def _cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


# ---- the edge attention of a shard -------------------------------------------


def _shard_args(v, a, b):
    """The port's arguments for the rows a..b of v, against the whole table."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(v["qp"]), t(v["ids"][a:b]), t(v["d"][a:b]), t(v["r"][a:b]), t(v["nq"][a:b]),
            t(v["k0"]), t(v["b0"]), t(_block_diag(v["k1"])), t(v["b1"]),
            t(_block_diag(v["k2"])), t(np.concatenate(v["b2"])))


@pytest.mark.parametrize("nn", [8, 64])
@pytest.mark.parametrize("shards", [2, 4])
def test_edge_plain_on_a_shard_matches_tpu_kernel_rows(nn, shards, record_property):
    """Each shard's rows, computed against the whole table with its offset,
    are the TPU kernel's rows of the whole structure; and the plain
    version's rows of the whole structure."""
    N = 64
    v = _inputs(N, nn, seed=nn + shards)
    want_q, want_p = _tpu_kernel(v, np.float32)
    whole_q, whole_p = ea.edge_attention_plain(*_shard_args(v, 0, N), S=S, Nh=NH, Nk=NK)
    worst = 0.0
    for k in range(shards):
        a, b = k * N // shards, (k + 1) * N // shards
        zq, zp = ea.fused_edge_attention(*_shard_args(v, a, b), S=S, Nh=NH, Nk=NK, row0=a)
        assert zq.shape == (b - a, NH * S) and zp.shape == (b - a, 3 * NH * S)
        for got, want, whole in ((zq, want_q, whole_q), (zp, want_p, whole_p)):
            np.testing.assert_allclose(got.numpy(), want[a:b], **EDGE_TOL)
            torch.testing.assert_close(got, whole[a:b], atol=1e-6, rtol=0)
            worst = max(worst, float(np.abs(got.numpy() - want[a:b]).max()))
    record_property("max_abs_dev_tpu_kernel", worst)


def test_edge_function_on_a_shard_gives_the_plain_gradient():
    """EdgeAttentionFunction with a table and an offset: its gradient of
    every input, the whole table's included, is the plain version's."""
    g = torch.Generator().manual_seed(1)
    N, n, row0, nn = 40, 16, 12, 8
    ids = torch.randint(0, N, (n, nn), generator=g, dtype=torch.int32)
    shapes = [(N, 4 * S), None, (n, nn), (n, nn, 3), (n, 12), (6 * S + 1, 4 * S), (4 * S,),
              (4 * S, 4 * S), (4 * S,), (4 * S, 76), (76,)]
    leaves = [ids if s is None else (torch.randn(*s, generator=g, dtype=torch.float64) * 0.3).requires_grad_()
              for s in shapes]

    def standin(*args):
        with torch.no_grad():
            return ea.edge_attention_plain(*args)

    outs = ea.EdgeAttentionFunction.apply(standin, S, 2, 3, *leaves, row0)
    w = [torch.randn(o.shape, generator=g, dtype=torch.float64) for o in outs]
    wrt = [t for t in leaves if t is not ids]
    got = torch.autograd.grad(outs, wrt, w)
    ref = torch.autograd.grad(ea.edge_attention_plain(*leaves, 32, 2, 3, row0), wrt, w)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)
    assert float(got[0][:row0].abs().sum()) > 0  # rows outside the shard are reached as neighbours


# ---- the sharded forward --------------------------------------------------------


@pytest.fixture(scope="module")
def sp_case(model):
    jcfg, params, cfg, sd = model
    ps = random_padded_structure(n_atoms=500, n_res=60, na=512, nr=64, seed=0)
    args = [np.asarray(x) for x in (ps.X, ps.ids_topk, ps.q, ps.M, ps.atom_mask)]
    z_jax = np.asarray(JaxModel(jcfg).apply({"params": params}, *args))
    z_jax_sp = np.asarray(jax_sp_forward(jcfg, jax_make_mesh(n_model=8, devices=jax.devices()[:8]))(params, *args))
    m = PestoModel(cfg)
    m.load_state_dict(sd)
    m.eval()
    targs = [torch.tensor(a) for a in args]
    with torch.no_grad():
        z_single = m(*targs).numpy()
    return m, targs, z_single, z_jax, z_jax_sp


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sp_forward_matches_single_device_and_jax(sp_case, shards, record_property):
    m, targs, z_single, z_jax, z_jax_sp = sp_case
    comm.reset()
    z = make_sp_forward(m, _cpu_mesh(1, shards))(*targs).numpy()
    # per forward: one Dmax reduction, an all-gather per layer, one pool merge
    assert comm.counts() == dict(comm.counts(), all_max=1, all_gather_rows=len(m.sum), merge_to=1)
    assert comm.total() == len(m.sum) + 2
    for want in (z_single, z_jax, z_jax_sp):
        np.testing.assert_allclose(z, want, atol=LOGIT_ATOL, rtol=0)
    record_property("max_abs_dev_single", float(np.abs(z - z_single).max()))
    record_property("max_abs_dev_jax_sp", float(np.abs(z - z_jax_sp).max()))


def test_sp_forward_replicates_per_distinct_device(model):
    _, _, cfg, sd = model
    m = PestoModel(cfg)
    m.load_state_dict(sd)
    fwd = make_sp_forward(m, _cpu_mesh(1, 4))
    assert list(fwd.replicas) == [torch.device("cpu")] and fwd.replicas[torch.device("cpu")] is m
    assert fwd.bounds(512) == [(0, 128), (128, 256), (256, 384), (384, 512)]


# ---- Predictor: sharded structures and data-parallel serving ------------------------


@pytest.mark.parametrize("variant", ["i_v4_0", "i_v3_0"])  # codes of one vocabulary; of three
def test_predict_structure_sp_matches_predict_structure_and_jax(model, variant, record_property):
    jcfg, params, cfg, sd = model
    if variant != "i_v4_0":
        jcfg = _four_layers(jax_config(variant, remat=False))
        params = numpy_params(jcfg, seed=5)
        cfg = _four_layers(get_config(variant))
        sd = state_dict_from_jax_params(params, cfg)
    rec = random_structure_record(n_atoms=400, n_res=60, seed=7)
    pred = Predictor(cfg, sd, device="cpu")
    single = pred.predict_structure(dict(rec))
    got = pred.predict_structure_sp(dict(rec), _cpu_mesh(1, 8))
    want = JaxPredictor(jcfg, params).predict_structure_sp(
        dict(rec), jax_make_mesh(n_model=8, devices=jax.devices()[:8]))
    assert got.shape == single.shape == want.shape == (60, 5)
    np.testing.assert_allclose(got, single, atol=SP_PROB_TOL, rtol=SP_PROB_TOL)
    np.testing.assert_allclose(got, want, atol=SP_PROB_TOL, rtol=SP_PROB_TOL)
    # an equal mesh made anew reuses the cached replicas
    pred.predict_structure_sp(dict(rec), _cpu_mesh(1, 8))
    assert len(pred._sp_cache) == 1
    record_property("max_abs_dev_single", float(np.abs(got - single).max()))
    record_property("max_abs_dev_jax", float(np.abs(got - want).max()))


def test_dp_predict_batch_matches_one_device_and_jax_mesh(model, monkeypatch, record_property):
    """Six records in three buckets of 3, 1 and 2 structures: a chunk of
    an odd count is padded with a copy of its first structure, and each is
    split in two equal parts, one per device, and served with no
    collective."""
    jcfg, params, cfg, sd = model
    records = [random_structure_record(n_atoms=150 + 40 * i, n_res=20 + 4 * i, seed=i) for i in range(6)]
    single = Predictor(cfg, sd, device="cpu").predict_batch(records)
    mesh_pred = Predictor(cfg, sd, mesh=_cpu_mesh(2, 1))
    assert mesh_pred.device == torch.device("cpu")
    parts = []
    run = mesh_pred._forward

    def counting(*sides):
        parts.append(sides[0][0].shape[0])
        return run(*sides)

    monkeypatch.setattr(mesh_pred, "_forward", counting)
    comm.reset()
    got = mesh_pred.predict_batch(records)
    assert comm.total() == 0
    assert parts == [2, 2, 1, 1, 1, 1]
    want = JaxPredictor(jcfg, params, mesh=jax_make_mesh(n_data=2, devices=jax.devices()[:2])).predict_batch(
        records)
    worst = 0.0
    for g, s, w in zip(got, single, want):
        assert g.shape == s.shape == w.shape
        np.testing.assert_allclose(g, s, atol=DP_PROB_TOL, rtol=DP_PROB_TOL)
        np.testing.assert_allclose(g, w, atol=DP_PROB_TOL, rtol=DP_PROB_TOL)
        worst = max(worst, float(np.abs(g - w).max()))
    record_property("max_abs_dev_jax", worst)
