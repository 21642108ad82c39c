"""The port's dimer model (`models/extras.py`, `models/cross.py`,
`port.cross_state_dict_from_jax_params`) on the CPU against the JAX
package's, with the same weights and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesto_tpu.models import get_config as jax_config
from pesto_tpu.models.cross import CrossPestoModel as JaxCross
from pesto_tpu.models.cross import init_cross_params
from pesto_tpu.models.extras import CrossStateUpdateLayer as JaxCrossLayer
from pesto_tpu.models.extras import state_max_pool as jax_state_max_pool
from pesto_tpu.models.pesto import unpack_state_features as jax_unpack
from pesto_tpu.synthetic import random_padded_structure
from pesto_tpu_torch.models import CrossPestoModel, get_config, state_max_pool
from pesto_tpu_torch.models import pesto as port_pesto
from pesto_tpu_torch.ops import edge_attention
from pesto_tpu_torch.port import cross_state_dict_from_jax_params

LOGIT_ATOL = 1e-5
GRAD_REL_L2 = 1e-4
ZERO_GRAD = 1e-6


def _two_layers(cfg):
    return cfg.replace(layers=tuple(cfg.layers[i] for i in (0, 4)))  # nn = 8 and 16


@pytest.fixture(scope="module")
def weights():
    jcfg = _two_layers(jax_config("i_v4_0", remat=False))
    cfg = _two_layers(get_config("i_v4_0"))
    shapes = jax.eval_shape(lambda r: init_cross_params(jcfg, r), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(path, s):
        scale = 1.0 / np.sqrt(s.shape[-2]) if path[-1].key == "kernel" else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    model = CrossPestoModel(cfg)
    model.load_state_dict(cross_state_dict_from_jax_params(params, cfg), strict=True)
    return jcfg, params, cfg, model


def _structure(seed, n_atoms, n_res, na=128, nr=32):
    """A padded structure whose padding rows carry garbage coordinates and
    features (the models must mask them)."""
    ps = random_padded_structure(n_atoms=n_atoms, n_res=n_res, na=na, nr=nr, seed=seed)
    X, q0 = np.array(ps.X), np.array(ps.q)
    rng = np.random.RandomState(seed + 100)
    X[n_atoms + 1 :] = rng.rand(na - n_atoms - 1, 3) * 30
    q0[n_atoms + 1 :] = 1.0
    return (X, np.asarray(ps.ids_topk), q0, np.asarray(ps.M), np.asarray(ps.atom_mask))


def _torch(S):
    return tuple(torch.as_tensor(np.array(x)) for x in S)


@pytest.fixture(scope="module")
def pair():
    return _structure(0, 90, 18), _structure(1, 61, 12)


def test_cross_state_dict_key_by_key(weights):
    jcfg, params, cfg, model = weights
    sd = cross_state_dict_from_jax_params(params, cfg)
    assert sorted(sd) == sorted(model.state_dict())
    k = np.asarray(params["csul_1"]["cqm"]["Dense_2"]["kernel"])
    np.testing.assert_array_equal(sd["csul.1.cqm.4.weight"].numpy(), k.T)
    k = np.asarray(params["csul_0"]["sul"]["su"]["epkm"]["Dense_1"]["bias"])
    np.testing.assert_array_equal(sd["csul.0.sul.su.epkm.2.bias"].numpy(), k)
    np.testing.assert_array_equal(sd["spl.zdm_vec.0.weight"].numpy(),
                                  np.asarray(params["spl"]["zdm_vec"]["kernel"]).T)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == sum(1 for k in sd if k.endswith((".weight", ".bias")))
    # a leaf left over, or one missing, is refused
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra["csul_0"]["cqm"]["Dense_3"] = {"kernel": np.zeros((32, 6), np.float32)}
    with pytest.raises(ValueError, match="exactly once"):
        cross_state_dict_from_jax_params(extra, cfg)
    short = jax.tree_util.tree_map(lambda x: x, params)
    del short["csul_1"]["ckm"]["Dense_2"]
    with pytest.raises(ValueError, match="do not match"):
        cross_state_dict_from_jax_params(short, cfg)


def test_state_max_pool_matches_jax():
    rng = np.random.RandomState(2)
    N, R, S = 12, 4, 5
    q = rng.randn(N, S).astype(np.float32)
    p = rng.randn(N, 3, S).astype(np.float32)
    M = np.zeros((N, R), np.float32)
    M[np.arange(N), np.arange(N) % R] = 1.0
    q[M[:, 2] > 0] = -np.abs(q[M[:, 2] > 0]) - 0.1  # residue 2: all members negative
    p[5] = -p[1]  # atoms 1 and 5 (both residue 1): equal norms, a tie
    got = state_max_pool(torch.as_tensor(q), torch.as_tensor(p), torch.as_tensor(M))
    want = jax_state_max_pool(jnp.asarray(q), jnp.asarray(p), jnp.asarray(M))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][2] == 0).all()  # non-members count as 0
    # x and z: atoms 1 and 5 tie at the largest norm of residue 1, and the
    # first is taken; y: atom 9's norm is larger
    np.testing.assert_array_equal(got[1][1][[0, 2]], p[1][[0, 2]])
    np.testing.assert_array_equal(got[1][1][1], p[9][1])


def _layer_inputs(S, state_seed, width=32):
    X, ids, _, _, am = S
    n_real = jnp.sum(jnp.asarray(am)).astype(jnp.int32)
    D, R = jax_unpack(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(am), n_real)
    rng = np.random.RandomState(state_seed)
    q = rng.randn(len(X), width).astype(np.float32) * am[:, None]
    p = rng.randn(len(X), 3, width).astype(np.float32) * am[:, None, None]
    return (q, p, np.asarray(ids), np.asarray(D), np.asarray(R), am)


def test_cross_layer_matches_jax(weights, pair, record_property):
    jcfg, params, cfg, model = weights
    Z0, Z1 = _layer_inputs(pair[0], 3), _layer_inputs(pair[1], 4)
    want = jax.jit(JaxCrossLayer(jcfg.layers[1]).apply)({"params": params["csul_1"]},
                                                        tuple(map(jnp.asarray, Z0)), tuple(map(jnp.asarray, Z1)))
    with torch.no_grad():
        got = model.csul[1](_torch(Z0), _torch(Z1))
    worst = 0.0
    for g2, w2 in zip(got, want):
        for g, w in zip(g2, w2):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL)
            worst = max(worst, float(np.abs(g.numpy() - np.asarray(w)).max()))
    assert (got[0][0][0] == 0).all() and (got[1][0][62:] == 0).all()  # sink and padding re-zeroed
    record_property("max_abs_dev", worst)


def test_cross_model_matches_jax(weights, pair, monkeypatch, record_property):
    jcfg, params, cfg, model = weights
    A, B = pair
    zA, zB = jax.jit(JaxCross(jcfg).apply)({"params": params}, tuple(map(jnp.asarray, A)),
                                           tuple(map(jnp.asarray, B)))
    calls = []

    def counting(*args, **kw):
        calls.append(args[1].shape[1])
        return edge_attention.fused_edge_attention(*args, **kw)

    monkeypatch.setattr(port_pesto, "fused_edge_attention", counting)
    launches = edge_attention.edge_attention_kernel.launches
    with torch.no_grad():
        tA, tB = model(_torch(A), _torch(B))
    assert calls == [8, 16]  # each layer's edge attention once, over both structures' rows
    assert edge_attention.edge_attention_kernel.launches == launches  # the plain version on the CPU
    assert tA.shape == (32, cfg.dm_n2) and tB.shape == (32, cfg.dm_n2)
    np.testing.assert_allclose(tA.numpy(), np.asarray(zA), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tB.numpy(), np.asarray(zB), atol=LOGIT_ATOL)
    # swapping the pair swaps the outputs (shared parameters)
    with torch.no_grad():
        sB, sA = model(_torch(B), _torch(A))
    np.testing.assert_allclose(sA.numpy(), tA.numpy(), atol=1e-6)
    np.testing.assert_allclose(sB.numpy(), tB.numpy(), atol=1e-6)
    record_property("max_abs_dev", float(max(np.abs(tA.numpy() - np.asarray(zA)).max(),
                                             np.abs(tB.numpy() - np.asarray(zB)).max())))


def _counting_edge(monkeypatch):
    """Each fused_edge_attention call's neighbour ids' shape [rows, nn]."""
    calls = []

    def counting(*args, **kw):
        calls.append(tuple(args[1].shape))
        return edge_attention.fused_edge_attention(*args, **kw)

    monkeypatch.setattr(port_pesto, "fused_edge_attention", counting)
    return calls


def test_the_one_pair_call_is_the_batched_call_on_one_pair(weights, pair, monkeypatch):
    """[NA, ...] sides give, at tolerance 0, the batched call's answer on a
    batch of that one pair, with one edge attention a layer over both
    structures' rows."""
    *_, model = weights
    A, B = (_torch(S) for S in pair)
    calls = _counting_edge(monkeypatch)
    with torch.no_grad():
        one = model(A, B)
    rows = len(A[0]) + len(B[0])
    assert calls == [(rows, 8), (rows, 16)]
    with torch.no_grad():
        batch = model(tuple(t[None] for t in A), tuple(t[None] for t in B))
    for o, b in zip(one, batch):
        assert o.shape == b.shape[1:] and torch.equal(o, b[0])


def test_the_cross_layer_entry_runs_one_edge_attention(weights, pair, monkeypatch):
    """The layer's JAX-shaped entry (two structures' states) is `pairs` over
    one table of both structures' rows: one edge attention, and the same
    rows at tolerance 0."""
    *_, model = weights
    layer = model.csul[1]
    Z0, Z1 = (_torch(_layer_inputs(S, seed)) for S, seed in zip(pair, (3, 4)))
    n0 = len(Z0[0])
    calls = _counting_edge(monkeypatch)
    with torch.no_grad():
        (q0, p0), (q1, p1) = layer(Z0, Z1)
    assert calls == [(n0 + len(Z1[0]), 16)]
    table = [torch.cat([a, b]) for a, b in zip(Z0, (*Z1[:2], Z1[2] + n0, *Z1[3:]))]
    segments = (torch.tensor([1, n0 + 1], dtype=torch.int32),
                torch.tensor([int(Z0[5].sum()), int(Z1[5].sum())], dtype=torch.int32),
                torch.tensor([1, 0], dtype=torch.int32), n0 - 1)
    with torch.no_grad():
        q, p = layer.pairs(*table, segments)
    assert torch.equal(torch.cat([q0, q1]), q) and torch.equal(torch.cat([p0, p1]), p)


@pytest.fixture(scope="module")
def jax_grads(weights, pair):
    jcfg, params, cfg, _ = weights
    A, B = (tuple(map(jnp.asarray, S)) for S in pair)
    jm = JaxCross(jcfg)

    def loss(p):
        zA, zB = jm.apply({"params": p}, A, B)
        return jnp.sum(zA**2) + jnp.sum(zB**2)

    return cross_state_dict_from_jax_params(jax.jit(jax.grad(loss))(params), cfg)


@pytest.mark.parametrize("fused", [True, False], ids=["packed", "literal"])
def test_cross_model_gradient_matches_jax(weights, pair, jax_grads, fused, record_property):
    """Each parameter's gradient of sum(zA^2) + sum(zB^2) within a relative
    L2 error of GRAD_REL_L2 of JAX's. The last bias of the softmax key MLPs
    (eqkm over neighbours, ckm over the partner's atoms, the pool's sam
    over atoms) shifts every logit of a softmax row alike, so its exact
    gradient is 0: there both frameworks' norms stay below ZERO_GRAD of the
    largest gradient norm."""
    _, params, cfg, _ = weights
    model = CrossPestoModel(cfg.replace(fused_edges=fused))
    model.load_state_dict(cross_state_dict_from_jax_params(params, cfg))
    A, B = pair
    tA, tB = model(_torch(A), _torch(B))
    ((tA**2).sum() + (tB**2).sum()).backward()
    named = dict(model.named_parameters())
    assert len(named) == sum(1 for k in jax_grads if k.endswith((".weight", ".bias")))
    largest = max(np.linalg.norm(jax_grads[k].numpy()) for k in named)
    worst = 0.0
    for name, prm in named.items():
        g, w = prm.grad.numpy(), jax_grads[name].numpy()
        assert np.isfinite(g).all(), name
        if name.endswith(("eqkm.4.bias", "ckm.4.bias", "sam.4.bias")):
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= ZERO_GRAD * largest, name
            continue
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rel <= GRAD_REL_L2, (name, rel)
        worst = max(worst, rel)
    record_property("max_grad_rel_l2", worst)
