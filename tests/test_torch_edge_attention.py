"""The port's plain edge attention against the TPU kernel
(geometric_pallas.fused_edge_attention in Pallas interpret mode) on the same
numpy inputs, each in its own layout; and against the port's literal
StateUpdate."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesto_tpu.ops import geometric_pallas as gp
from pesto_tpu_torch.models.config import LayerConfig
from pesto_tpu_torch.models.pesto import StateUpdate
from pesto_tpu_torch.ops import edge_attention as ea_mod
from pesto_tpu_torch.ops.edge_attention import edge_attention_plain, fused_edge_attention

S, NH, NK = 32, 2, 3


def _inputs(N, nn, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    r = f(N, nn, 3)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    return dict(
        qp=f(N, 4 * S), ids=rng.randint(0, N, (N, nn)).astype(np.int32),
        d=(rng.rand(N, nn) * 8).astype(np.float32), r=r, nq=f(N, 2 * NH * NK),
        k0=f(6 * S + 1, 4 * S, sc=1 / 14), b0=f(4 * S, sc=0.1),
        k1=[f(S, S, sc=1 / 6), f(S, S, sc=1 / 6), f(2 * S, 2 * S, sc=1 / 8)], b1=f(4 * S, sc=0.1),
        k2=[f(S, NK, sc=1 / 6), f(S, 3 * NK, sc=1 / 6), f(2 * S, 2 * S, sc=1 / 8)],
        b2=[f(NK, sc=0.1), f(3 * NK, sc=0.1), f(2 * S, sc=0.1)],
    )


def _block_diag(blocks):
    out = np.zeros((sum(b.shape[0] for b in blocks), sum(b.shape[1] for b in blocks)), np.float32)
    i = j = 0
    for b in blocks:
        out[i : i + b.shape[0], j : j + b.shape[1]] = b
        i, j = i + b.shape[0], j + b.shape[1]
    return out


def _port(v, dt):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    zq, zp = fused_edge_attention(
        t(v["qp"]), torch.from_numpy(v["ids"]), t(v["d"]), t(v["r"]), t(v["nq"]),
        t(v["k0"]), t(v["b0"]), t(_block_diag(v["k1"])), t(v["b1"]),
        t(_block_diag(v["k2"])), t(np.concatenate(v["b2"])), S=S, Nh=NH, Nk=NK,
    )
    return zq.float().numpy(), zp.float().numpy()


def _tpu_kernel(v, dt, neighbours=None):
    """The JAX kernel's nn-major inputs and lane-aligned K2 packing;
    `neighbours` [nn, N, 4S] where v["qp"] holds only the atoms' own rows."""
    a = lambda x: jnp.asarray(x, dtype=dt)  # noqa: E731
    nn = v["ids"].shape[1]
    k2a, b2a = gp.pack_k2_aligned(*[a(x) for x in v["k2"]], *[a(x) for x in v["b2"]], S, NK, dt)
    zq, zp = gp.fused_edge_attention(
        a(v["qp"][v["ids"].T] if neighbours is None else neighbours), a(v["d"].T), a(np.transpose(v["r"], (1, 0, 2))),
        a(v["qp"][:, :S]), a(v["qp"][:, S:]), a(v["k0"][: 1 + 2 * S]), a(v["b0"]),
        a(v["k0"][1 + 2 * S :]), a(_block_diag(v["k1"])), a(v["b1"]), k2a, b2a, a(v["nq"]),
        S=S, Nh=NH, Nk=NK, nn=nn, interpret=True,
    )
    return np.asarray(zq, np.float32), np.asarray(zp, np.float32)


@pytest.mark.parametrize("nn", [8, 64])
def test_plain_matches_tpu_kernel_fp32(nn, record_property):
    v = _inputs(64, nn, seed=nn)
    for name, got, want in zip(("zq", "zp"), _port(v, torch.float32), _tpu_kernel(v, jnp.float32)):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        record_property(f"max_abs_dev_{name}", float(np.abs(got - want).max()))


def test_plain_matches_tpu_kernel_bf16(record_property):
    v = _inputs(64, 16, seed=2)
    for name, got, want in zip(("zq", "zp"), _port(v, torch.bfloat16), _tpu_kernel(v, jnp.bfloat16)):
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
        record_property(f"max_abs_dev_{name}", float(np.abs(got - want).max()))


@pytest.mark.parametrize("nn", [8, 32])
def test_packed_state_update_matches_literal(nn, record_property):
    """StateUpdate through the packed plain edge attention equals the
    literal reference computation with the same weights."""
    torch.manual_seed(nn)
    lit = StateUpdate(LayerConfig(nn=nn), fused=False)
    packed = StateUpdate(LayerConfig(nn=nn), fused=True)
    packed.load_state_dict(lit.state_dict())
    N = 96
    g = torch.Generator().manual_seed(nn)
    q, p = torch.randn(N, S, generator=g), torch.randn(N, 3, S, generator=g)
    qp = torch.cat([q, p.reshape(N, 3 * S)], dim=1)
    ids = torch.randint(0, N, (N, nn), generator=g, dtype=torch.int32)
    d = torch.rand(N, nn, generator=g) * 8
    r = torch.nn.functional.normalize(torch.randn(N, nn, 3, generator=g), dim=-1)
    with torch.no_grad():
        for name, a, b in zip(("q", "p"), lit(q, p, qp, ids, d, r), packed(q, p, qp, ids, d, r)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
            record_property(f"max_abs_dev_{name}", float((a - b).abs().max()))


def test_packed_weights_follow_weight_changes():
    """The packed edge-MLP weights are kept between calls and packed anew
    after an in-place change, a state-dict load or a dtype move; under
    autograd they stay connected to the weights."""
    su = StateUpdate(LayerConfig(nn=8))
    mlps = (su.eqkm, su.epkm, su.evm)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with torch.no_grad():
        first = su.packed_weights()
        assert su.packed_weights() is first
        su.evm[2].weight.mul_(2.0)
        second = su.packed_weights()
        assert second is not first and same(second, StateUpdate._pack(mlps))
        other = StateUpdate(LayerConfig(nn=8))
        su.load_state_dict(other.state_dict())
        assert same(su.packed_weights(), StateUpdate._pack((other.eqkm, other.epkm, other.evm)))
        su.to(torch.bfloat16)
        assert all(w.dtype == torch.bfloat16 for w in su.packed_weights())
    su.to(torch.float32)
    K0 = su.packed_weights()[0]
    assert K0.requires_grad and K0.grad_fn is not None


# ---- the kernel's product arithmetic, emulated on the CPU -------------------
#
# csrc/edge_attention.cu runs the three edge-MLP products on the tensor
# cores. fp32: 3xTF32, x = hi + lo with hi = x rounded to 10 mantissa bits
# (to nearest, ties away from zero: (bits + 0x1000) & ~0x1fff) and lo = x - hi,
# which the tensor core truncates to 10 mantissa bits; a product is
# lo*hi + hi*lo + hi*hi, summed in fp32. bf16: the A operands (E, h0, h1) are
# rounded to bf16, the products summed in fp32.


def _tf32_round(x):
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    # the products of two 11-bit significands are exact in fp64
    return (al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()).float()


def _matmul_bf16_operands(a, b):
    return a.bfloat16().float() @ b.bfloat16().float()


def _port_plain(v, dt, matmul, row0=0):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dt).float()  # noqa: E731
    zq, zp = edge_attention_plain(
        t(v["qp"]), torch.from_numpy(np.ascontiguousarray(v["ids"])), t(v["d"]), t(v["r"]), t(v["nq"]),
        t(v["k0"]), t(v["b0"]), t(_block_diag(v["k1"])), t(v["b1"]),
        t(_block_diag(v["k2"])), t(np.concatenate(v["b2"])), S=S, Nh=NH, Nk=NK, row0=row0, matmul=matmul,
    )
    return zq.numpy(), zp.numpy()


def test_tf32_split_error_bound():
    """hi + lo, as the tensor core reads them, is x to within 2^-21 |x|."""
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(100_000).astype(np.float32)) * 10
    hi = _tf32_round(x)
    assert torch.equal(_tf32_round(hi), hi) and torch.equal(_tf32_trunc(hi), hi)
    err = ((hi.double() + _tf32_trunc(x - hi).double()) - x.double()).abs() / x.double().abs()
    assert err.max().item() <= 2.0**-21


@pytest.mark.parametrize("nn", [8, 16, 32, 64])
def test_3xtf32_products_hold_fp32_tolerance(nn, record_property):
    """The plain version with its three MLP products done as the fp32 kernel
    does them (3xTF32) stays within the fp32 kernel's tolerance of the fp32
    plain version and of the TPU kernel (interpret mode), at every nn the
    kernel takes."""
    v = _inputs(64, nn, seed=100 + nn)
    got = _port_plain(v, torch.float32, _matmul_3xtf32)
    for ref_name, ref in (("plain", _port(v, torch.float32)), ("tpu", _tpu_kernel(v, jnp.float32))):
        for name, a, b in zip(("zq", "zp"), got, ref):
            np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-4)
            record_property(f"max_abs_dev_{ref_name}_{name}", float(np.abs(a - b).max()))


@pytest.mark.parametrize("nn", [8, 64])
def test_3xtf32_products_hold_fp32_tolerance_on_a_table_shard(nn, record_property):
    """The same on one shard of a larger table (row0 > 0, ids over the whole
    table), as an SP shard launches the kernel: against the fp32 plain
    version of the shard and the TPU kernel given the shard's own rows."""
    N, n_table, row0 = 48, 160, 64
    v = _inputs(n_table, nn, seed=300 + nn)
    v["ids"] = v["ids"][row0 : row0 + N]
    for k in ("d", "r", "nq"):
        v[k] = v[k][row0 : row0 + N]
    got = _port_plain(v, torch.float32, _matmul_3xtf32, row0=row0)
    plain = _port_plain(v, torch.float32, torch.matmul, row0=row0)
    own = dict(v, qp=v["qp"][row0 : row0 + N])
    tpu = _tpu_kernel(own, jnp.float32, neighbours=v["qp"][v["ids"].T])
    for ref_name, ref in (("plain", plain), ("tpu", tpu)):
        for name, a, b in zip(("zq", "zp"), got, ref):
            np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-4)
            record_property(f"max_abs_dev_{ref_name}_{name}", float(np.abs(a - b).max()))


def test_single_tf32_misses_fp32_tolerance(record_property):
    """One TF32 product per MLP stage (hi * hi) does not hold the fp32
    tolerance: the reason the fp32 kernel takes three."""
    v = _inputs(64, 64, seed=164)
    got = _port_plain(v, torch.float32, lambda a, b: (_tf32_round(a).double() @ _tf32_round(b).double()).float())
    ref = _port(v, torch.float32)
    excess = max(float((np.abs(a - b) - 5e-5 - 1e-4 * np.abs(b)).max()) for a, b in zip(got, ref))
    record_property("max_excess_over_fp32_tolerance", excess)
    assert excess > 0


@pytest.mark.parametrize("nn", [16, 64])
def test_bf16_operand_products_match_tpu_kernel_bf16(nn, record_property):
    """The plain version with E, h0 and h1 rounded to bf16 before each
    product (the bf16 kernel's operands, fp32 sums) against the TPU kernel
    in bf16, interpret mode."""
    v = _inputs(64, nn, seed=200 + nn)
    got = _port_plain(v, torch.bfloat16, _matmul_bf16_operands)
    for name, a, b in zip(("zq", "zp"), got, _tpu_kernel(v, jnp.bfloat16)):
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=5e-2)
        record_property(f"max_abs_dev_{name}", float(np.abs(a - b).max()))


# ---- the fp32 kernel's split weights, mirrored in numpy ------------------------
#
# csrc/edge_attention.cu splits the weights once per launch into 27 slabs of
# TF32 hi and lo (wg::split_source) and its three products read them slab by
# slab (wg::h1_slab, h1_off, out_slab, out_off, and slab kk for h0's k step
# kk), each k step's B in wgmma's K-major core matrices with the k order
# that makes an accumulator fragment an A fragment. The mirror below lays
# the slabs out the same way, reads them back the way the products do and
# must give E K0e, h0 K1 and h1 K2.

CU = Path(__file__).resolve().parents[1] / "pesto_tpu_torch" / "csrc" / "edge_attention.cu"


def _cu_const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    return int(m.group(1))


def _slot_row(t):
    """Source row (within the k step) of k slot t: columns 2t, then 2t + 1."""
    return 2 * t if t < 4 else 2 * t - 7


def _k_steps():
    """(slab, offset, matrix, first row, first column, N, valid columns) of
    every k step, in the order the products read them."""
    steps = []
    for kk in range(16):  # h0: region kk % 4, column block kk // 4 of E
        steps.append((kk, 0, "K0e", 32 * (kk % 4) + 8 * (kk // 4), 0, 128, 128))
    for j in range(16):  # h1 = h0 K1 by its diagonal blocks
        slab = 16 if j < 4 else 17 if j < 8 else 18 + (j - 8) // 2
        off = (j % 4) * 512 if j < 8 else ((j - 8) % 2) * 1024
        n = 32 if j < 8 else 64
        steps.append((slab, off, "K1", 8 * j, 0 if j < 4 else 32 if j < 8 else 64, n, n))
    for j in range(16):  # out = h1 K2: 3 and 9 columns padded to 8 and 16
        slab = 22 if j < 8 else 23 + (j - 8) // 2
        off = 128 * j if j < 4 else 512 + 256 * (j - 4) if j < 8 else ((j - 8) % 2) * 1024
        n, nvalid, col0 = (8, NK, 0) if j < 4 else (16, 3 * NK, NK) if j < 8 else (64, 64, 4 * NK)
        steps.append((slab, off, "K2", 8 * j, col0, n, nvalid))
    return steps


def _split_slabs(mats):
    """The slabs as the pre-pass writes them: for each k step, N x 8 hi
    words then N x 8 lo words, word ((2 ng + h) * 8 + n8) * 4 + e holding
    column 8 ng + n8 of k slot 4 h + e."""
    slabs = np.zeros((_cu_const("NSLAB"), _cu_const("SLAB")), np.float32)
    for slab, off, mat, k0, col0, n, nvalid in _k_steps():
        w = np.zeros((8, n), np.float32)
        rows = [k0 + _slot_row(t) for t in range(8)]
        w[:, :nvalid] = mats[mat][rows][:, col0 : col0 + nvalid]
        hi = _tf32_round(torch.from_numpy(w)).numpy()
        for part, x in ((0, hi), (1, w - hi)):
            c = np.arange(8 * n)
            ng, h, n8, e = c // 64, (c // 32) % 2, (c // 4) % 8, c % 4
            slabs[slab, off + part * 8 * n + c] = x[4 * h + e, 8 * ng + n8]
    return slabs


def test_split_weight_slabs_give_the_three_products():
    rng = np.random.RandomState(5)
    v = _inputs(8, 8, seed=5)
    mats = {"K0e": v["k0"][1 + 2 * S :], "K1": _block_diag(v["k1"]), "K2": _block_diag(v["k2"])}
    slabs = _split_slabs(mats).astype(np.float64)
    # the wrapper allocates the kernel's split weights after the per-atom terms
    assert slabs.size == int(re.search(r"SPLIT_FLOATS == (\d+)", CU.read_text()).group(1)) == ea_mod._SPLIT_FLOATS
    x = {m: rng.standard_normal((64, 128)) for m in mats}
    got = {m: np.zeros((64, mats[m].shape[1])) for m in mats}
    for slab, off, mat, k0, col0, n, nvalid in _k_steps():
        flat = slabs[slab, off : off + 16 * n]
        c = np.arange(8 * n)
        b = np.zeros((8, n))
        b[4 * ((c // 32) % 2) + c % 4, 8 * (c // 64) + (c // 4) % 8] = flat[: 8 * n] + flat[8 * n :]  # hi + lo
        a = x[mat][:, [k0 + _slot_row(t) for t in range(8)]]  # the A fragment's k slots
        got[mat][:, col0 : col0 + nvalid] += (a @ b)[:, :nvalid]
    for m in mats:
        want = x[m] @ mats[m].astype(np.float64)
        np.testing.assert_allclose(got[m], want, rtol=1e-12, atol=1e-12)
