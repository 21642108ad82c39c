"""The port's plain versions of the five Mosaic repro kernels against the TPU
kernels of docs/mosaic_repros.py, run in Pallas interpret mode on the same
seeded numpy inputs: bit for bit, a NaN equal to any NaN.

docs/mosaic_repros.py is loaded as it is: pallas_call is patched to
interpret mode (its compiler_params dropped) and the module's `_run` is
replaced by a recorder, so every case yields the callable of each variant,
which is called here on the test's own inputs."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from pesto_tpu_torch.ops import mosaic_repros as ops
from pesto_tpu_torch.scripts import mosaic_repros as script

ROOT = pathlib.Path(__file__).resolve().parents[1]


def interpret_mode(orig):
    """pallas_call in interpret mode, without the TPU compiler parameters."""

    def call(kernel, **kw):
        kw.pop("compiler_params", None)
        return orig(kernel, interpret=True, **kw)

    return call


@pytest.fixture(scope="module")
def tpu_kernels():
    """The pallas_call callable of every variant of docs/mosaic_repros.py,
    in the order the script runs them."""
    spec = importlib.util.spec_from_file_location("tpu_mosaic_repros",
                                                  ROOT / "docs" / "mosaic_repros.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    recorded = []
    mod._run = lambda label, fn, *args: recorded.append(fn)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpret_mode(pl.pallas_call))
        for case in mod.CASES.values():
            case()
    assert len(recorded) == 9
    return recorded


def to_torch(a):
    """A JAX or numpy array as a CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_bits(bits):
    return np.array(bits, np.uint32).view(np.float32)


def randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def bf16broadcast_input(seed):
    x = randn(seed, (256, 128))
    x[5, 17], x[9, 3], x[12, 100] = np.nan, np.inf, -np.inf
    return x


def i1carry_input(seed):
    x = (np.random.RandomState(seed).rand(8, 128) * 3.5 - 0.5).astype(np.float32)
    x[0, :4], x[0, 4:8], x[1:, 8:12] = 0.0, 0.5, 0.5
    return x


SPECIAL_BITS = (0x80000000, 0x7F800000, 0xFF800000, 0x7FC12345, 0x00012345, 0x3F800000)


def bisecting_rows(seed):
    d = np.abs(randn(seed, (256, 512)))
    d *= (10.0 ** (2 + 2 * (np.arange(256) % 3)))[:, None].astype(np.float32)
    d[3, 7] = d[100, 0] = np.nan
    return d


def _same(jax_out, port_out):
    want = to_torch(jax_out)
    assert ops.same_bits(port_out, want), (port_out, want)


@pytest.mark.parametrize("raised", [False, True], ids=["default_budget", "raised_budget"])
def test_vmem500(tpu_kernels, raised):
    x = randn(0, (4096, 1280))
    fn = tpu_kernels[int(raised)]
    _same(fn(jnp.asarray(x)), ops.scale_add(torch.from_numpy(x), raised=raised))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16broadcast(tpu_kernels, dtype):
    xj = jnp.asarray(bf16broadcast_input(1), dtype=dtype)
    got = tpu_kernels[2 if dtype == "float32" else 3](xj)
    assert np.isnan(np.asarray(got, np.float32)[5]).all()  # jnp.max lets the NaN win
    _same(got, ops.rowmax_mul(to_torch(xj)))


@pytest.mark.parametrize("as_bool", [False, True], ids=["i32_carry", "bool_carry"])
def test_i1carry(tpu_kernels, as_bool):
    x = i1carry_input(2)
    fn = tpu_kernels[5 if as_bool else 4]
    sums = []
    for n in range(9):
        nj = np.array([n], np.int32)
        got = fn(jnp.asarray(x), jnp.asarray(nj))
        _same(got, ops.carry_and(torch.from_numpy(x), torch.from_numpy(nj), as_bool=as_bool))
        sums.append(float(np.asarray(got).sum()))
    assert len(set(sums)) > 3  # n changes the answer


@pytest.mark.parametrize("rank", [1, 0], ids=["rank1", "rank0"])
def test_bitcast0(tpu_kernels, rank):
    fn = tpu_kernels[6 if rank == 1 else 7]
    for bits in SPECIAL_BITS:
        x = randn(3, (1, 128))
        x[0, 0] = from_bits([bits])[0]
        got = fn(jnp.asarray(x))
        assert (np.asarray(got).view(np.uint32) == bits).all()
        _same(got, ops.bitcast_first(torch.from_numpy(x), rank=rank))


@pytest.mark.parametrize("rows", ["script_abs_randn", "bisecting"])
def test_bisecthang(tpu_kernels, rows):
    d = np.abs(randn(4, (256, 512))) if rows == "script_abs_randn" else bisecting_rows(4)
    got = tpu_kernels[8](jnp.asarray(d))
    _same(got, ops.bisect_mask(torch.from_numpy(d)))
    per_row = np.asarray(got).sum(axis=1)
    if rows == "script_abs_randn":
        assert (per_row == 512).all()  # never leaves the first branch
    else:
        assert ((per_row >= 64) & (per_row <= 256)).all()  # every row bisects


def test_same_bits_tells_signed_zeros_and_nans_apart():
    a = torch.tensor([0.0, float("nan"), 1.0])
    assert ops.same_bits(a, a.clone())
    assert not ops.same_bits(a, torch.tensor([-0.0, float("nan"), 1.0]))
    assert not ops.same_bits(a, torch.tensor([0.0, 2.0, 1.0]))
    assert ops.same_bits(a, torch.tensor([0.0, -float("nan"), 1.0]))


def test_script_runs_every_case_on_cpu(capsys):
    assert script.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("bit for bit equal to the plain version: True") == 10
    assert "False" not in out


# ------------------------------------------------ bisect_mask's select, emulated
#
# csrc/mosaic_repros.cu's bisect_mask does not count per step: it finds v64,
# the row's 64th smallest value that is not NaN, replays the 16 steps on it
# (a step goes up exactly when v64 > mid) and writes hi >= d. It finds v64
# under a bound: each thread's least value, the 8th least of those in each
# warp, and of those the least that 64 threads' minima are at or under; the
# values at or under the bound are ranked, or, when there are more than BISECT_CANDIDATES of them, a radix
# select over the row's order-preserving keys takes over. The emulation
# below runs those steps in numpy, with the kernel's own thread layout,
# bound, candidate limit and digit widths, read from the source. (Rows
# wider than one stage of shared memory, which read their rest through L2,
# are not emulated: every width here fits.)


def _cu_constants():
    """The `constexpr` int and float scalars of csrc/mosaic_repros.cu, in
    order: {name: value}."""
    import re

    src = pathlib.Path(ops.__file__).resolve().parent.parent / "csrc" / "mosaic_repros.cu"
    found = {}
    for kind, name, expr in re.findall(r"^constexpr (int|float) (\w+) = ([^;]+);", src.read_text(), re.M):
        expr = re.sub(r"(\d)f\b", r"\1", expr).replace("/", "//" if kind == "int" else "/")
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    return found


CU = _cu_constants()
DIGITS = (CU["BISECT_DIGIT1"], CU["BISECT_DIGIT2"], CU["BISECT_DIGIT3"])
BISECT_WIDTHS = (1, 63, 64, 65, 511, 512, 8191)


def order_keys(x):
    """uint32 keys in the order of the float32 values x (none NaN)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return b ^ np.where(b >> 31, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def key_value(k):
    k = np.uint32(k)
    return (k ^ np.uint32(0x80000000) if k >> 31 else ~k).view(np.float32)


def find_bin(hist, k):
    """(bin holding the k-th counted key, k less the keys below that bin),
    as the kernel's block scan finds them."""
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, k))
    return b, k - int(cum[b] - hist[b])


def radix_select(keys, k):
    """The k-th least of the keys by the kernel's three digit sweeps."""
    d1, d2, d3 = DIGITS
    p1, k = find_bin(np.bincount(keys >> (32 - d1), minlength=1 << d1), k)
    shared = keys[(keys >> (32 - d1)) == p1]
    b2, k = find_bin(np.bincount((shared >> d3) & ((1 << d2) - 1), minlength=1 << d2), k)
    p2 = (p1 << d2) | b2
    b3, _ = find_bin(np.bincount(keys[(keys >> d3) == p2] & ((1 << d3) - 1), minlength=1 << d3), k)
    return (p2 << d3) | b3


def emulate_bisect_row(row, pad=0):
    """(mask, v64, "rank" or "radix") of one float32 row whose base lies
    `pad` floats past 16-byte alignment, by the kernel's steps."""
    threads, K = CU["BISECT_THREADS"], ops.BISECT_K
    # value c sits in float4 slot (pad + c) // 4 of the stage; thread t holds
    # slots 4t .. 4t + 3 and sweeps slots past those every `threads`
    held, slot = CU["BISECT_HELD_SLOTS"], (pad + np.arange(len(row))) // 4
    thread = np.where(slot < held, slot // CU["BISECT_HELD"], (slot - held) % threads)
    lane_min = np.full(threads, np.inf, np.float32)
    np.minimum.at(lane_min, thread[~np.isnan(row)], row[~np.isnan(row)])
    lane_keys = order_keys(lane_min)
    warp_kth = np.sort(lane_keys.reshape(CU["BISECT_WARPS"], 32), axis=1)[:, CU["BISECT_LANES"] - 1]
    # the least of the warps' bounds that 64 lanes' minima are at or under
    bound = key_value(min(b for b in warp_kth if (lane_keys <= b).sum() >= K))
    cand = order_keys(row[row <= bound])
    if np.isfinite(bound):
        assert len(cand) >= K  # 64 lanes hold a value at or under the bound
    if len(cand) <= CU["BISECT_CANDIDATES"]:
        # v64 is the largest key with fewer than 64 keys under it, and hi
        # the largest replay of those keys; +inf and BISECT_HI under 64 keys
        path, v64, hi = "rank", np.float32(np.inf), np.float32(CU["BISECT_HI"])
        if len(cand) >= K:
            less = (cand[None, :] < cand[:, None]).sum(axis=1)
            v64 = key_value(cand[less < K].max())
            hi = max(replay(key_value(c)) for c in cand[less < K])
    else:
        path, v64 = "radix", key_value(radix_select(order_keys(row[~np.isnan(row)]), K))
        hi = replay(v64)
    assert hi == replay(v64)
    return hi >= row, v64, path


def replay(v64):
    """The 16 steps from v64 (a step goes up when v64 > mid): hi."""
    lo, hi = np.float32(0), np.float32(CU["BISECT_HI"])
    for _ in range(CU["BISECT_STEPS"]):
        mid = np.float32(0.5) * (lo + hi)
        lo, hi = (mid, hi) if v64 > mid else (lo, mid)
    return hi


def emulate_bisect(d, pad=0):
    rows = [emulate_bisect_row(r, pad) for r in d]
    return np.stack([m for m, _, _ in rows]), [v for _, v, _ in rows], [p for _, _, p in rows]


def nth_smallest(row, n=64):
    vals = np.sort(row[~np.isnan(row)])
    return vals[n - 1] if len(vals) >= n else np.float32(np.inf)


@pytest.mark.parametrize("name", ["BISECT_K", "BISECT_STEPS", "BISECT_HI"])
def test_bisect_constants_match_the_kernel(name):
    assert CU[name] == getattr(ops, name)
    assert sum(DIGITS) == 32


@pytest.mark.parametrize("pad", [0, 1, 3])
@pytest.mark.parametrize("cols", BISECT_WIDTHS)
def test_bisect_select_emulation_matches_plain(cols, pad):
    """The kernel's steps give bisect_mask_plain's mask bit for bit on
    every kind of adversarial row, at every alignment of the row's base,
    and v64 is the 64th smallest value."""
    d = script.adversarial_rows(cols, 2 * len(script.ADVERSARIAL_KINDS), cols)
    mask, v64, paths = emulate_bisect(d, pad)
    want = ops.bisect_mask_plain(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(mask, want)
    for row, v in zip(d, v64):
        assert v == nth_smallest(row)  # -0.0 and +0.0 may stand for each other
    assert "rank" in paths
    if cols > CU["BISECT_CANDIDATES"]:
        assert "radix" in paths  # ties at the bound: the radix select ran too


def test_bisect_select_emulation_matches_tpu_kernel(tpu_kernels):
    """Against JAX's case_bisecthang kernel in interpret mode at its
    [256, 512] shape, on adversarial rows and on the script's rows."""
    for d in (script.adversarial_rows(5, 256, 512), bisecting_rows(6)):
        got = np.asarray(tpu_kernels[8](jnp.asarray(d)))
        np.testing.assert_array_equal(emulate_bisect(d)[0], got)
        np.testing.assert_array_equal(ops.bisect_mask_plain(torch.from_numpy(d)).numpy(), got)


@pytest.mark.parametrize("seed", range(40))
def test_bisect_select_emulation_random_widths(seed):
    """Seeded widths 1-700 and magnitudes 1e-3..1e7, with NaN, ±inf, -0.0,
    negatives and ties at visited pivots."""
    rng = np.random.RandomState(1000 + seed)
    cols = int(rng.randint(1, 701))
    d = script.adversarial_rows(seed, 8, cols)
    d[0] = np.abs(rng.standard_normal(cols)).astype(np.float32) * np.float32(10.0 ** rng.uniform(-3, 7))
    np.testing.assert_array_equal(emulate_bisect(d)[0], ops.bisect_mask_plain(torch.from_numpy(d)).numpy())


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(cols=st.integers(1, 700), exponent=st.floats(-3, 7), seed=st.integers(0, 2**31 - 1))
def test_bisect_select_emulation_hypothesis(cols, exponent, seed):
    """Widths and magnitudes drawn by hypothesis: the emulation against
    bisect_mask_plain, bit for bit."""
    d = script.adversarial_rows(seed, 8, cols)
    d[1::2] *= np.float32(10.0 ** exponent)
    np.testing.assert_array_equal(emulate_bisect(d)[0], ops.bisect_mask_plain(torch.from_numpy(d)).numpy())
