"""The edge layer's explicit backward (`edge_attention_backward_plain`, the
function of csrc/edge_attention_bwd.cu) on the CPU: against torch autograd
of the plain forward, against `jax.vjp` of the JAX package's packed
StateUpdate, and with the kernel's bf16 roundings emulated in numpy; the
backward kernel's wrapper checks and the autograd Function's two paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesto_tpu.models import get_config as jax_config
from pesto_tpu.models.config import LayerConfig as JaxLayerConfig
from pesto_tpu.models.pesto import StateUpdate as JaxStateUpdate
from pesto_tpu.models.pesto import init_params
from pesto_tpu_torch.models import get_config
from pesto_tpu_torch.models import pesto as port_pesto
from pesto_tpu_torch.models.config import LayerConfig
from pesto_tpu_torch.models.pesto import StateUpdate
from pesto_tpu_torch.ops import _build
from pesto_tpu_torch.ops import edge_attention as ea
from pesto_tpu_torch.port import state_dict_from_jax_params

S, NH, NK = 32, 2, 3
F64_ATOL = 1e-10  # float64: the two computations differ only in summation order
# fp32 against JAX: summation order (XLA's and torch's), per gradient
# tensor, floored at 1e-4 of the largest norm (a gradient that is 0 in exact
# arithmetic, the last bias of eqkm, shifts every logit of a softmax alike)
JAX_REL_L2 = 1e-4
# bf16: per tensor, the emulated kernel's error against the float64
# backward at most this times the plain bf16 backward's (chip_smoke.py
# phase 3's rule)
BF16_RATIO = 2.0


def _inputs(N, nn, dt=torch.float64, n_table=None, seed=0):
    """Seeded inputs of one layer in the port's layout (K1, K2 block-diagonal)."""
    n_table = n_table or N
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * sc).to(dt)

    r = f(N, nn, 3)
    r = r / r.norm(dim=-1, keepdim=True)
    return [f(n_table, 4 * S), torch.from_numpy(rng.randint(0, n_table, (N, nn)).astype(np.int32)),
            torch.from_numpy(rng.rand(N, nn) * 8).to(dt), r, f(N, 2 * NH * NK),
            f(6 * S + 1, 4 * S, sc=1 / 14), f(4 * S, sc=0.1),
            torch.block_diag(f(S, S), f(S, S), f(2 * S, 2 * S)) / 8, f(4 * S, sc=0.1),
            torch.block_diag(f(S, NK), f(S, 3 * NK), f(2 * S, 2 * S)) / 8, f(76, sc=0.1)]


def _grads_out(N, dt=torch.float64, seed=1, zero_every=None):
    rng = np.random.RandomState(seed)
    gq = torch.from_numpy(rng.standard_normal((N, NH * S))).to(dt)
    gp = torch.from_numpy(rng.standard_normal((N, 3 * NH * S))).to(dt)
    if zero_every:
        gq[::zero_every] = 0
        gp[::zero_every] = 0
    return gq, gp


def _autograd(args, gq, gp, row0=0):
    """Autograd of edge_attention_plain: the gradients of qp, d, r, nq and
    the weights, K1's and K2's on their diagonal blocks."""
    leaves = [a.clone().requires_grad_() if a.is_floating_point() else a for a in args]
    outs = ea.edge_attention_plain(*leaves, S=S, Nh=NH, Nk=NK, row0=row0)
    grads = list(torch.autograd.grad(outs, [a for a in leaves if a.requires_grad], (gq, gp)))
    m1, m2 = ea.block_masks(grads[6], grads[8])
    grads[6], grads[8] = grads[6] * m1, grads[8] * m2
    return grads


def _case(name, nn):
    """(args, gq, gp, row0) of a named case."""
    if name == "plain":
        args, row0 = _inputs(40, nn, seed=nn), 0
        gq, gp = _grads_out(40)
    elif name == "row0":  # the atoms are rows 37..77 of a 120-row table
        args, row0 = _inputs(40, nn, n_table=120, seed=nn), 37
        gq, gp = _grads_out(40)
    elif name == "sink":  # duplicate ids; the last 12 rows gather row 0 only, with zero gradients
        args, row0 = _inputs(40, nn, seed=nn), 0
        args[1][:, 1] = args[1][:, 0]
        args[1][28:] = 0
        gq, gp = _grads_out(40)
        gq[28:], gp[28:] = 0, 0
    elif name == "zero_p":  # p = 0, as at layer 0: safe_norm's floor holds everywhere
        args, row0 = _inputs(40, nn, seed=nn), 0
        args[0][:, S:] = 0
        gq, gp = _grads_out(40)
    else:  # "skipped": every third atom reaches no loss
        args, row0 = _inputs(40, nn, seed=nn), 0
        gq, gp = _grads_out(40, zero_every=3)
    return args, gq, gp, row0


@pytest.mark.parametrize("name,nn", [("plain", nn) for nn in (8, 16, 32, 64)]
                         + [(name, 16) for name in ("row0", "sink", "zero_p", "skipped")])
def test_backward_plain_matches_autograd(name, nn, record_property):
    """Every gradient of the explicit backward equals autograd's in float64."""
    args, gq, gp, row0 = _case(name, nn)
    got = ea.edge_attention_backward_plain(*args, gq, gp, S=S, Nh=NH, Nk=NK, row0=row0)
    worst = 0.0
    for what, a, b in zip(ea.GRAD_NAMES, got, _autograd(args, gq, gp, row0)):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F64_ATOL, rtol=0, err_msg=what)
        worst = max(worst, float((a - b).abs().max()))
    record_property("max_abs_dev", worst)
    if name == "zero_p":  # no gradient reaches p through the norms' floor, only through the projections
        assert torch.isfinite(got[0]).all()
    if name == "skipped":
        assert not got[1][::3].any() and not got[2][::3].any() and not got[3][::3].any()


def test_backward_plain_leaves_out_what_is_not_needed():
    args, gq, gp, row0 = _case("plain", 8)
    need = (True, False, False, True, True, True, True, True, True, True)
    got = ea.edge_attention_backward_plain(*args, gq, gp, need=need)
    full = ea.edge_attention_backward_plain(*args, gq, gp)
    for want, a, b in zip(need, got, full):
        assert (a is None) if not want else torch.equal(a, b)


# ---- against jax.vjp of the JAX package's StateUpdate -------------------------


def _jax_layer(nn, seed):
    """(JAX StateUpdate, its params, the port's StateUpdate with the same
    weights through state_dict_from_jax_params)."""
    jcfg = jax_config("i_v4_0", remat=False, scan_layers=False).replace(layers=(JaxLayerConfig(nn=nn),))
    shapes = jax.eval_shape(lambda k: init_params(jcfg, k, na=64, nr=8), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        scale = 1.0 / np.sqrt(s.shape[-2]) if path[-1].key == "kernel" else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    cfg = get_config("i_v4_0").replace(layers=(LayerConfig(nn=nn),), scan_layers=False)
    su = StateUpdate(LayerConfig(nn=nn), fused=True)
    prefix = "sum.0.su."
    su.load_state_dict({k[len(prefix):]: v for k, v in state_dict_from_jax_params(params, cfg).items()
                        if k.startswith(prefix)})
    return JaxStateUpdate(JaxLayerConfig(nn=nn), fused=True, pallas=False), params, cfg, su


class _Explicit(torch.autograd.Function):
    """The plain forward, differentiated by edge_attention_backward_plain."""

    @staticmethod
    def forward(ctx, row0, *inputs):
        ctx.row0 = row0
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return ea.edge_attention_plain(*inputs, S=S, Nh=NH, Nk=NK, row0=row0)

    @staticmethod
    def backward(ctx, gq, gp):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        g = ea.edge_attention_backward_plain(*saved, gq, gp, S=S, Nh=NH, Nk=NK, row0=ctx.row0,
                                             need=need[:1] + need[2:])
        return (None, g[0], None, *g[1:])


@pytest.mark.parametrize("nn", [8, 32])
def test_layer_vjp_matches_jax(nn, monkeypatch, record_property):
    """The port's StateUpdate with its edge attention differentiated by the
    explicit backward: the VJP of (q', p') with respect to q, p, d, r and
    every parameter, against jax.vjp of pesto_tpu's StateUpdate(fused=True,
    pallas=False) on the same numpy inputs, fp32."""
    N = 48
    jsu, params, cfg, su = _jax_layer(nn, seed=nn)
    rng = np.random.RandomState(100 + nn)
    q = rng.standard_normal((N, S)).astype(np.float32)
    p = (0.5 * rng.standard_normal((N, 3, S))).astype(np.float32)
    p[: N // 4] = 0  # atoms whose vector state is still zero (safe_norm's floor)
    ids = rng.randint(0, N, (N, nn)).astype(np.int32)
    d = (rng.rand(N, nn) * 8).astype(np.float32)
    r = rng.standard_normal((N, nn, 3)).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    cq = rng.standard_normal((N, S)).astype(np.float32)
    cp = rng.standard_normal((N, 3, S)).astype(np.float32)

    def layer(prm, q, p, d, r):
        qp = jnp.concatenate([q, p.reshape(N, 3 * S)], axis=1)[ids]
        return jsu.apply({"params": prm}, q, p, qp[..., :S], qp[..., S:].reshape(N, nn, 3, S), d, r)

    node = params["sul_0"]["su"]
    _, vjp = jax.vjp(layer, node, *map(jnp.asarray, (q, p, d, r)))
    g_node, g_q, g_p, g_d, g_r = vjp((jnp.asarray(cq), jnp.asarray(cp)))
    tree = jax.tree_util.tree_map(np.zeros_like, params)
    tree["sul_0"]["su"] = jax.tree_util.tree_map(np.asarray, g_node)
    prefix = "sum.0.su."
    want = {k[len(prefix):]: v for k, v in state_dict_from_jax_params(tree, cfg).items()
            if k.startswith(prefix) and k.endswith(("weight", "bias"))}

    def through_explicit(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, S, Nh, Nk, row0):
        return _Explicit.apply(row0, qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2)

    monkeypatch.setattr(port_pesto, "fused_edge_attention", through_explicit)
    tq, tp, td, tr = (torch.from_numpy(x).requires_grad_() for x in (q, p, d, r))
    tqp = torch.cat([tq, tp.reshape(N, 3 * S)], dim=1)
    oq, op = su(tq, tp, tqp, torch.from_numpy(ids), td, tr)
    torch.autograd.backward((oq, op), (torch.from_numpy(cq), torch.from_numpy(cp)))
    got = {k: v.grad for k, v in su.named_parameters()}
    got.update(q=tq.grad, p=tp.grad, d=td.grad, r=tr.grad)
    want.update(q=torch.from_numpy(np.array(g_q)), p=torch.from_numpy(np.array(g_p)),
                d=torch.from_numpy(np.array(g_d)), r=torch.from_numpy(np.array(g_r)))
    assert set(got) == set(want)
    floor = 1e-4 * max(float(w.double().norm()) for w in want.values())
    errs = {k: float((got[k].double() - want[k].double()).norm()) / max(float(want[k].double().norm()), floor)
            for k in want}
    worst = max(errs, key=errs.get)
    record_property("worst_rel_l2", (worst, errs[worst]))
    assert errs[worst] <= JAX_REL_L2, (worst, errs[worst])


# ---- the kernel's bf16 arithmetic, emulated ------------------------------------


def _bf16(x):
    """fp32 -> bf16 (round to nearest, ties to even) -> fp32, in numpy;
    finite values only."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _bf16_t(x):
    return torch.from_numpy(_bf16(x.detach().numpy()))


def _matmul_bf16(a, b):
    """A product on bf16 operands with fp32 sums, as the kernel's bf16 mma."""
    return torch.from_numpy(np.matmul(_bf16(a.numpy()), _bf16(b.numpy())))


def test_bf16_rounding_emulation():
    """numpy's bf16 rounding is torch's."""
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(100_000).astype(np.float32)) * 7
    assert torch.equal(_bf16_t(x), x.bfloat16().float())


@pytest.mark.parametrize("nn", [8, 64])
def test_bf16_emulation_within_the_rule(nn, record_property):
    """The backward with the kernel's bf16 roundings (every product's
    operands, among them E, h0, h1 and the gradients, rounded to bf16 and
    summed in fp32; h0, h1, out and dE rounded to bf16 where the kernel
    keeps them in shared memory, so elu' and the edge features read the
    rounded values; the results rounded to bf16) is, per gradient tensor,
    within twice the plain bf16 backward's error against the float64
    backward of the same bf16 inputs."""
    args, gq, gp, row0 = _case("skipped", nn)
    bf = [a.bfloat16() if a.is_floating_point() else a for a in (*args, gq, gp)]
    ref = ea.edge_attention_backward_plain(*[a.double() if a.is_floating_point() else a for a in bf])
    plain = ea.edge_attention_backward_plain(*bf)
    emulated = [_bf16_t(g) for g in ea.edge_attention_backward_plain(
        *[a.float() if a.is_floating_point() else a for a in bf], matmul=_matmul_bf16, rnd=_bf16_t)]
    floor = 1e-4 * max(float(w.norm()) for w in ref)

    def err(a, b):
        return float((a.double() - b).norm()) / max(float(b.norm()), floor)

    ratios = {n: err(e, w) / err(p, w) for n, e, p, w in zip(ea.GRAD_NAMES, emulated, plain, ref)}
    record_property("ratios", ratios)
    assert max(ratios.values()) <= BF16_RATIO, ratios


# ---- the kernel's wrapper and the autograd Function ----------------------------


class CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0 to the wrapper's checks."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _kernel_args(N=16, nn=8, n_table=None, cuda=True, **change):
    args = dict(zip(("qp", "ids", "d", "r", "nq", "K0", "B0", "K1", "B1", "K2", "B2"),
                    _inputs(N, nn, dt=torch.float32, n_table=n_table)))
    args["grad_zq"], args["grad_zp"] = _grads_out(N, dt=torch.float32)
    args.update(change)
    if cuda:
        args = {k: v.as_subclass(CudaLike) if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    return args


@pytest.fixture
def recorded(monkeypatch):
    """Every entry records its name instead of calling C; the scratch
    entry returns 64 floats."""
    calls = []

    def call(entry, *args):
        assert len(args) == len(entry.kinds), entry.name
        calls.append(entry.name)
        return 64 if entry.host else None

    monkeypatch.setattr(_build.Entry, "__call__", call)
    monkeypatch.setattr(ea.edge_attention_backward_kernel, "launches", 0)
    return calls


REFUSED = {
    "cpu": dict(cuda=False),
    "nn": dict(nn=12),
    "dtype": dict(grad_zp=torch.zeros(16, 192, dtype=torch.float64)),
    "shape grad_zq": dict(grad_zq=torch.zeros(16, 32)),
    "shape grad_zp": dict(grad_zp=torch.zeros(15, 192)),
    "strided grad_zq": dict(grad_zq=torch.zeros(64, 16).t()),
    "shape K1": dict(K1=torch.zeros(128, 127)),
    "row0": dict(row0=5),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_backward_kernel_refuses(recorded, case):
    change = dict(REFUSED[case])
    cuda = change.pop("cuda", True)
    row0 = change.pop("row0", 0)
    with pytest.raises(ValueError):
        ea.edge_attention_backward_kernel(**_kernel_args(cuda=cuda, **change), row0=row0)
    assert recorded == [] and ea.edge_attention_backward_kernel.launches == 0


@pytest.mark.parametrize("need", [(True,) * 10, (True, False, False, True, True, True, True, True, True, True)])
def test_backward_kernel_accepts_and_counts_one_launch(recorded, need):
    got = ea.edge_attention_backward_kernel(**_kernel_args(n_table=40), row0=24, need=need)
    assert recorded == ["edge_attention_bwd_scratch", "edge_attention_bwd"]
    assert ea.edge_attention_backward_kernel.launches == 1
    assert [g is not None for g in got] == list(need)
    assert got[0].shape == (40, 4 * S) and got[4].shape == (6 * S + 1, 4 * S)


def test_function_on_cuda_launches_the_kernel_and_never_the_plain_version(monkeypatch):
    """EdgeAttentionFunction.backward on (stand-in) CUDA tensors: one call of
    the backward kernel with the needed flags, its gradients in the
    Function's order, and no rerun of edge_attention_plain."""
    args = _kernel_args(n_table=40)
    inputs = [args[k] for k in ("qp", "ids", "d", "r", "nq", "K0", "B0", "K1", "B1", "K2", "B2")]
    calls = []

    def kernel(*a, need):
        calls.append((len(a), a[-4:], need))
        return tuple(object() if n else None for n in need)

    def forbidden(*a, **k):
        raise AssertionError("edge_attention_plain called in the backward")

    monkeypatch.setattr(ea, "edge_attention_backward_kernel", kernel)
    monkeypatch.setattr(ea, "edge_attention_plain", forbidden)

    class Ctx:
        saved_tensors = tuple(inputs)
        dims = (S, NH, NK, 24)
        needs_input_grad = (False,) * 4 + (True, False, False, False, True) + (True,) * 6 + (False,)

    grads = ea.EdgeAttentionFunction.backward(Ctx, args["grad_zq"], args["grad_zp"])
    assert len(calls) == 1 and calls[0][0] == 13 + 4 and calls[0][1] == (S, NH, NK, 24)
    assert calls[0][2] == (True, False, False, True) + (True,) * 6
    assert len(grads) == 4 + 11 + 1
    assert [g is not None for g in grads] == [False] * 4 + [True, False, False, False, True] + [True] * 6 + [False]


def test_function_on_cpu_gives_the_plain_gradient(monkeypatch):
    """On CPU tensors the Function reruns the plain version under autograd
    (no kernel), and its gradients are the explicit backward's."""
    monkeypatch.setattr(ea.edge_attention_backward_kernel, "launches", 0)
    args, gq, gp, row0 = _case("row0", 16)
    leaves = [a.clone().requires_grad_() if a.is_floating_point() else a for a in args]

    def standin(*a):
        with torch.no_grad():
            return ea.edge_attention_plain(*a)

    outs = ea.EdgeAttentionFunction.apply(standin, S, NH, NK, *leaves, row0)
    got = torch.autograd.grad(outs, [a for a in leaves if a.requires_grad], (gq, gp))
    want = ea.edge_attention_backward_plain(*args, gq, gp, row0=row0)
    m1, m2 = ea.block_masks(args[7], args[9])
    for what, a, b in zip(ea.GRAD_NAMES, got, want):
        a = a * m1 if what == "K1" else a * m2 if what == "K2" else a
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F64_ATOL, rtol=0, err_msg=what)
    assert ea.edge_attention_backward_kernel.launches == 0


# ---- the backward kernel's shared-memory layout and index maps ----------------
#
# numpy mirrors of csrc/edge_attention_bwd.cu's formulas: the tile swizzle
# `ti`, the lane addresses of the Mm<T> fragment loaders (ldmatrix x4, .trans,
# and fp32's 32-bit reads), the weights' padded strides, the fragment order
# of the dK1 / dK2 partials in shared memory (`pk_dense`) and the butterfly
# sums (`lanes_scatter`). The kernel itself runs only on the card.

TE, H = 64, 128


def _swz(e):
    return ((e & 3) << 1) | ((e >> 2) & 1)


def _ti(e, c, nbytes):
    """Element (e, c) of a [TE][H] tile whose 16-byte chunks are XOR-swizzled by the row."""
    v = 16 // nbytes
    return e * H + ((c // v) ^ _swz(e)) * v + c % v


@pytest.mark.parametrize("nbytes", [4, 2])
def test_tile_swizzle_is_a_bijection_without_bank_conflicts(nbytes):
    idx = np.array([[_ti(e, c, nbytes) for c in range(H)] for e in range(TE)])
    assert sorted(idx.ravel()) == list(range(TE * H))
    v = 16 // nbytes
    for e0 in range(0, TE, 8):  # ldmatrix: 8 rows at one chunk, 8 distinct 16-byte bank groups
        for c in range(0, H, v):
            assert len({(idx[e0 + r, c] * nbytes // 16) % 8 for r in range(8)}) == 8
    if nbytes == 4:  # fp32's transposed reads: rows e0 + q (q < 4), columns n0 .. n0 + 7: 32 banks
        for e0 in range(0, TE, 4):
            for n0 in range(0, H, 8):
                assert len({idx[e0 + q, n0 + g] % 32 for q in range(4) for g in range(8)}) == 32


def _ldmatrix(mem, addrs, trans, words=8):
    """ldmatrix .x4 on a flat array of 16-bit slots: lane l points at row l % 8
    of matrix l // 8 (8 slots from addrs[l]); returns out[lane][j] = the two
    slots lane gets from matrix j (non-trans: row lane / 4, slots 2 (lane % 4)
    and + 1; trans: slots lane / 4 of rows 2 (lane % 4) and + 1)."""
    out = np.zeros((32, 4, 2))
    for j in range(4):
        rows = [mem[addrs[8 * j + r]: addrs[8 * j + r] + words] for r in range(8)]
        for t in range(32):
            if trans:
                out[t, j] = [rows[2 * (t % 4)][t // 4], rows[2 * (t % 4) + 1][t // 4]]
            else:
                out[t, j] = rows[t // 4][2 * (t % 4): 2 * (t % 4) + 2]
    return out


def _frag_a16(frag):
    """The 16 x 16 A of m16n8k16 from each lane's 4 registers of 2 values."""
    a = np.zeros((16, 16))
    for t in range(32):
        g, q = t // 4, t % 4
        for j, (r, c) in enumerate(((g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8), (g + 8, 2 * q + 8))):
            a[r, c: c + 2] = frag[t, j]
    return a


def _frag_b16(frag):
    """The 16 x 16 B (k, n) of two m16n8k16 n tiles: registers 0, 1 tile 0, 2, 3 tile 1."""
    b = np.zeros((16, 16))
    for t in range(32):
        g, q = t // 4, t % 4
        for j, (k, n) in enumerate(((2 * q, g), (2 * q + 8, g), (2 * q, g + 8), (2 * q + 8, g + 8))):
            b[k: k + 2, n] = frag[t, j]
    return b


@pytest.mark.parametrize("kind", ["a_rows", "a_cols", "b_tile", "b_kn", "b_nk"])
def test_bf16_fragments_through_the_layout(kind, record_property):
    """Each bf16 loader's lane addresses, read back as ldmatrix delivers them,
    give the operand it means, and their product is A @ B or A.T @ B."""
    rng = np.random.RandomState(3)
    X = rng.standard_normal((TE, H))
    tile = np.zeros(TE * H)
    for e in range(TE):
        for c in range(H):
            tile[_ti(e, c, 2)] = X[e, c]
    W = rng.standard_normal((H, H))
    ld = H + 8  # K0e's padded stride
    wmem = np.zeros(H * ld)
    for k in range(H):
        wmem[k * ld: k * ld + H] = W[k]
    e0, k0, i0, n0 = 16, 32, 48, 80
    lanes = range(32)
    if kind == "a_rows":
        addrs = [_ti(e0 + (l & 7) + 8 * ((l >> 3) & 1), k0 + 8 * (l >> 4), 2) for l in lanes]
        got, want = _frag_a16(_ldmatrix(tile, addrs, False)), X[e0: e0 + 16, k0: k0 + 16]
    elif kind == "a_cols":  # A = X^T: rows i0 .., k = the tile's rows e0 ..
        addrs = [_ti(e0 + (l & 7) + 8 * (l >> 4), i0 + 8 * ((l >> 3) & 1), 2) for l in lanes]
        got, want = _frag_a16(_ldmatrix(tile, addrs, True)), X[e0: e0 + 16, i0: i0 + 16].T
    elif kind == "b_tile":  # B = the tile, k = its rows
        addrs = [_ti(e0 + (l & 7) + 8 * ((l >> 3) & 1), n0 + 8 * (l >> 4), 2) for l in lanes]
        got, want = _frag_b16(_ldmatrix(tile, addrs, True)), X[e0: e0 + 16, n0: n0 + 16]
    elif kind == "b_kn":  # B = W, stored [k][n]
        addrs = [(k0 + (l & 7) + 8 * ((l >> 3) & 1)) * ld + n0 + 8 * (l >> 4) for l in lanes]
        got, want = _frag_b16(_ldmatrix(wmem, addrs, True)), W[k0: k0 + 16, n0: n0 + 16]
    else:  # B = W^T, W stored [n][k]
        addrs = [(n0 + (l & 7) + 8 * (l >> 4)) * ld + k0 + 8 * ((l >> 3) & 1) for l in lanes]
        got, want = _frag_b16(_ldmatrix(wmem, addrs, False)), W[n0: n0 + 16, k0: k0 + 16].T
    np.testing.assert_array_equal(got, want)
    if kind in ("b_kn", "b_nk"):  # the padded rows put ldmatrix's 8 rows on 8 bank groups
        for j in range(4):
            assert len({(addrs[8 * j + r] * 2 // 16) % 8 for r in range(8)}) == 8
    other = rng.standard_normal((16, 16))
    prod = got @ other if kind.startswith("a") else other @ got
    ref = want @ other if kind.startswith("a") else other @ want
    np.testing.assert_allclose(prod, ref, rtol=0, atol=1e-12)
    record_property("checked", kind)


@pytest.mark.parametrize("kind", ["a_rows", "a_cols", "b_tile"])
def test_fp32_fragments_through_the_layout(kind):
    """fp32 (tf32 m16n8k8): a_rows by ldmatrix on the b16 view (a 16-byte row
    is 4 fp32 values: lane t gets value t % 4 of row t / 4), a_cols and b_tile
    by 32-bit reads; the fragments hold A (g | g + 8, q | q + 4) and B (k = q
    | q + 4, n = g) of the intended operand, and their product is A @ B."""
    rng = np.random.RandomState(4)
    X = rng.standard_normal((TE, H))
    tile = np.zeros(TE * H)
    for e in range(TE):
        for c in range(H):
            tile[_ti(e, c, 4)] = X[e, c]
    e0, k0, i0, n0 = 8, 40, 16, 64
    a = np.zeros((16, 8))
    b = np.zeros((8, 16))
    for t in range(32):
        g, q = t // 4, t % 4
        if kind == "a_rows":
            for j in range(4):  # lanes 8 j .. point at matrix j's rows
                addr = [_ti(e0 + (l & 7) + 8 * ((l >> 3) & 1), k0 + 4 * (l >> 4), 4) for l in range(32)][8 * j + g]
                r, c = (g + 8 * (j & 1), q + 4 * (j >> 1))
                a[r, c] = tile[addr + q]
        elif kind == "a_cols":
            for r, c, e, i in ((g, q, e0 + q, i0 + g), (g + 8, q, e0 + q, i0 + g + 8),
                               (g, q + 4, e0 + q + 4, i0 + g), (g + 8, q + 4, e0 + q + 4, i0 + g + 8)):
                a[r, c] = tile[_ti(e, i, 4)]
        else:
            for k, n, e, c in ((q, g, e0 + q, n0 + g), (q + 4, g, e0 + q + 4, n0 + g),
                               (q, g + 8, e0 + q, n0 + 8 + g), (q + 4, g + 8, e0 + q + 4, n0 + 8 + g)):
                b[k, n] = tile[_ti(e, c, 4)]
    if kind == "a_rows":
        want = X[e0: e0 + 16, k0: k0 + 8]
        np.testing.assert_array_equal(a, want)
    elif kind == "a_cols":
        want = X[e0: e0 + 8, i0: i0 + 16].T
        np.testing.assert_array_equal(a, want)
    else:
        want = X[e0: e0 + 8, n0: n0 + 16]
        np.testing.assert_array_equal(b, want)
    other = rng.standard_normal((8, 16) if kind != "b_tile" else (16, 8))
    got = a @ other if kind != "b_tile" else other @ b
    np.testing.assert_allclose(got, want @ other if kind != "b_tile" else other @ want, rtol=0, atol=1e-12)


def _pk_dense(i):
    """Mirror of pk_dense: the dense partial index (K1 at 128 * 128, K2 at
    2 * 128 * 128, row stride 76) of shared partial i, or -1."""
    S_, NK_, OV0 = 32, 3, 12
    PK_K2, PK_K2V = 12 * 512, 12 * 512 + 4 * 256
    if i < PK_K2:
        job, r, kind = i // 512, i % 512, 0
    elif i < PK_K2V:
        job, r, kind = (i - PK_K2) // 256, (i - PK_K2) % 256, 1
    else:
        job, r, kind = (i - PK_K2V) // 512, (i - PK_K2V) % 512, 2
    n, ln, k = r // 128, (r // 4) % 32, r % 4
    row, col = (ln >> 2) + 8 * (k >> 1), 8 * n + 2 * (ln & 3) + (k & 1)
    if kind == 0:
        i0 = 16 * job if job < 4 else 2 * S_ + 16 * ((job - 4) & 3)
        c0 = 0 if job < 2 else S_ if job < 4 else 2 * S_ + 32 * ((job - 4) >> 2)
        return ("K1", i0 + row, c0 + col)
    if kind == 1:
        r2 = 16 * job + row
        ok = (r2 < S_ and col < NK_) or (r2 >= S_ and NK_ <= col < OV0)
        return ("K2", r2, col) if ok else None
    return ("K2", 2 * S_ + 16 * (job & 3) + row, OV0 + 32 * (job >> 2) + col)


def test_shared_partials_cover_the_diagonal_blocks_once():
    """The fragment order of the dK1 and dK2 partials in shared memory maps
    one to one onto the diagonal blocks of K1 (q, p, v) and K2 (q, p, v)."""
    got = [d for d in (_pk_dense(i) for i in range(12 * 512 + 4 * 256 + 8 * 512)) if d is not None]
    assert len(got) == len(set(got))
    m1, m2 = ea.block_masks(torch.zeros(128, 128), torch.zeros(128, 76))
    want = {("K1", r, c) for r, c in zip(*np.nonzero(m1.numpy()))}
    want |= {("K2", r, c) for r, c in zip(*np.nonzero(m2.numpy()))}
    assert set(got) == want


def _lanes_scatter(v, m, R):
    """Mirror of lanes_scatter<N, R>(v, lane, m) over 32 lanes' values v[32][N]."""
    v = v.copy()
    N = v.shape[1]
    for r in range(R):
        mr, half = m << (R - 1 - r), N >> (r + 1)
        new = v[:, :half].copy()
        for lane in range(32):
            up, other = bool(lane & mr), lane ^ mr
            keep = v[lane, half + np.arange(half)] if up else v[lane, np.arange(half)]
            send = v[other, np.arange(half)] if other & mr else v[other, half + np.arange(half)]
            new[lane] = keep + send
        v = new
    return v


@pytest.mark.parametrize("N,R,m", [(8, 3, 4), (12, 2, 8), (12, 2, 1), (4, 2, 1), (2, 1, 4)])
def test_butterfly_sums_land_where_the_kernel_reads_them(N, R, m):
    """lanes_scatter: lane l ends with the sum, over the 2^R lanes that differ
    in bits m .. 2^(R-1) m, of index (N / 2^R) ((l / m) % 2^R) + j."""
    vals = np.random.RandomState(N * R + m).standard_normal((32, N))
    out = _lanes_scatter(vals, m, R)
    mask = ((1 << R) - 1) * m
    for lane in range(32):
        group = [l for l in range(32) if l & ~mask == lane & ~mask]
        for j in range(N >> R):
            np.testing.assert_allclose(out[lane, j], vals[group, (N >> R) * ((lane // m) % (1 << R)) + j].sum(),
                                       rtol=1e-12)
