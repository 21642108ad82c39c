"""The kNN kernel's schedule (pesto_tpu_torch/csrc/knn.cu), emulated in
plain torch on the CPU: Morton sort, a threshold per row from the window
of tiles around it, groups and tiles skipped by bounding box with the
kernel's margin, candidate buffers cut when past
SLOTS - TILE keys, and the selection by (value, original id). The emulation is held against
`knn_plain` (exactly: it takes the same values) and against
`pesto_tpu.topology.knn_topology(method="exact")` (ids equal except on
fp32 tie rows, ok equal), on the adversarial geometries of
pesto_tpu/topology.py (a regular lattice, a dense cluster with far
outliers, a colinear chain), on duplicates, n <= k, the sink and padding,
a batch of three structures and 1OL5."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesto_tpu import topology as jtopo
from pesto_tpu.io import read_pdb as jax_read_pdb
from pesto_tpu.spatial import morton_order
from pesto_tpu.synthetic import random_structure_arrays
from pesto_tpu_torch.ops import knn

GOLDEN = str(pathlib.Path(__file__).resolve().parent / "goldens" / "1OL5_A_i0.pdb")
NONE = 2**63 - 1


def _padded(clouds, NA):
    X = np.zeros((len(clouds), NA, 3), np.float32)
    m = np.zeros((len(clouds), NA), np.float32)
    for b, c in enumerate(clouds):
        X[b, 1 : len(c) + 1] = c
        m[b, 1 : len(c) + 1] = 1.0
    return X, m


def _values(x):
    """knn_plain's masked values of one structure (one row block), so the
    emulation selects from the very same numbers."""
    xyz, w = x[:, :3], x[:, 3]
    sq = w.clamp_min(0.0)
    dsq = (sq[:, None] + sq[None, :] - 2.0 * (xyz[0 : x.shape[0]] @ xyz.T)).clamp_min(0.0)
    cols = torch.arange(x.shape[0])
    dup = (cols[:, None] == cols[None, :]) | (dsq < 1e-4)
    return dsq + knn.PUSH * dup.to(dsq.dtype)


def _key_value(key):
    return float("inf") if key == NONE else float(torch.tensor([key >> 32], dtype=torch.int32)
                                                   .view(torch.float32))


def _boxes(xs, n, size):
    """(lo [m,3], hi [m,3], largest w [m]) of each run of `size` sorted
    valid atoms."""
    m = -(-n // size)
    pad = m * size - n
    xyz, w = xs[:n, :3].double(), xs[:n, 3].double()
    inf = float("inf")
    lo = torch.cat([xyz, torch.full((pad, 3), inf, dtype=torch.float64)]).view(m, size, 3).amin(1)
    hi = torch.cat([xyz, torch.full((pad, 3), -inf, dtype=torch.float64)]).view(m, size, 3).amax(1)
    wm = torch.cat([w, torch.full((pad,), -inf, dtype=torch.float64)]).view(m, size).amax(1)
    return lo, hi, wm


def _box_near(box, idx, rx, rw, tau):
    """For the boxes idx: whether the row needs them (the least squared
    distance from the row's atom to the box within the row's tau plus the
    rounding margin)."""
    lo, hi, wm = (a[idx] for a in box)
    gap = torch.maximum(torch.maximum(lo - rx, rx - hi), torch.zeros_like(lo - rx))
    d = (gap * gap).sum(-1)
    return ~(d > tau + knn.MARGIN_REL * (rw + wm) + knn.MARGIN_ABS)


def _prefix_bound(keys):
    """The largest key whose 16-bit value prefix is the 64th smallest
    prefix of keys."""
    p = int(torch.sort(keys >> 48).values[knn.K - 1])
    return (((p << 16) | 0xFFFF) << 32) | 0xFFFFFFFF


def emulate(xc4, slots=knn.SLOTS):
    """The kernel's schedule on [B, NA, 4] centred input, one sorted row at
    a time as one warp takes it -> (ids, ok, stats) with stats as the
    kernel counts them: pairs evaluated, the largest buffer fill, rows
    whose buffer was cut, cuts."""
    T, W = knn.TILE, knn.WINDOW
    assert slots - T >= knn.K
    B, NA, _ = xc4.shape
    ids = torch.zeros((B, NA, knn.K), dtype=torch.int32)
    ok = torch.zeros((B, NA, knn.K), dtype=torch.bool)
    stats = dict(pairs=0, fill=0, cut_rows=0, cuts=0)
    perm = torch.sort(knn.morton_keys_plain(xc4), dim=1, stable=True).indices
    for b in range(B):
        sid = perm[b]
        xs = xc4[b][sid]
        n = int((xs[:, 3] >= 0).sum())
        if n == 0:
            continue
        V = _values(xc4[b])[sid][:, sid][:n, :n].contiguous()
        keys = (V.view(torch.int32).to(torch.int64) << 32) | sid[:n].to(torch.int64)[None, :]
        nt, ng = -(-n // T), -(-n // knn.GROUP)
        tbox, gbox = _boxes(xs, n, T), _boxes(xs, n, knn.GROUP)
        for p in range(n):
            row = dict(buf=torch.empty(0, dtype=torch.int64), tau=NONE, cuts=0)
            rx, rw = xs[p, :3].double(), xs[p, 3].double()

            def append(k):
                """The keys of k at or under tau into the buffer; past
                slots - T it is cut to the keys at or under its prefix
                bound, or to its exact top 64 if those leave no room."""
                buf = torch.cat([row["buf"], k[k <= row["tau"]]])
                if len(buf) > slots - T:
                    stats["fill"] = max(stats["fill"], len(buf))
                    row["tau"] = min(row["tau"], _prefix_bound(buf))
                    buf = buf[buf <= row["tau"]]
                    if len(buf) > slots - T:
                        buf = torch.sort(buf).values[: knn.K]
                        row["tau"] = int(buf[-1])
                    row["cuts"] += 1
                row["buf"] = buf

            def near(box, idx):
                return _box_near(box, idx, rx, rw, _key_value(row["tau"]))

            t = p // T
            lo = max(0, min(t - W, nt - (2 * W + 1)))
            hi = min(nt, lo + 2 * W + 1)
            c0, c1 = lo * T, min(n, hi * T)
            stats["pairs"] += c1 - c0
            if c1 - c0 >= knn.K:
                row["tau"] = _prefix_bound(keys[p, c0:c1])
            for t0 in range(c0, c1, T):
                append(keys[p, t0 : min(c1, t0 + T)])
            # groups, then tiles, each box tested against the row's tau and
            # again when its turn comes; the row's own round of groups first
            rounds = -(-ng // 32)
            for ri in range(rounds):
                g0 = (t // 32 // 32 + ri) % rounds * 32
                gs = torch.arange(g0, min(ng, g0 + 32))
                for g in gs[near(gbox, gs)].tolist():
                    if not near(gbox, [g])[0]:
                        continue
                    ts = torch.arange(g * 32, min(nt, g * 32 + 32))
                    live = near(tbox, ts) & ((ts < lo) | (ts >= hi))
                    for tile in ts[live].tolist():
                        if near(tbox, [tile])[0]:
                            stats["pairs"] += min(n, (tile + 1) * T) - tile * T
                            append(keys[p, tile * T : min(n, (tile + 1) * T)])
            stats["fill"] = max(stats["fill"], len(row["buf"]))
            stats["cut_rows"] += row["cuts"] > 0
            stats["cuts"] += row["cuts"]
            s = torch.sort(row["buf"]).values[: knn.K]
            v = (s >> 32).to(torch.int32).view(torch.float32)
            good = v < knn.BIGHALF
            orig = int(sid[p])
            ids[b, orig, : len(s)] = torch.where(good, s & 0xFFFFFFFF, 0).to(torch.int32)
            ok[b, orig, : len(s)] = good
    return ids, ok, stats


def _assert_ids_match_jax(X, m, ids, ok):
    """ids equal to pesto_tpu's exact kNN except where the two chosen atoms
    tie in squared distance within fp32 rounding of the Gram form (the
    tolerance of tests/test_torch_topology.py); ok equal. Returns the tie
    rows."""
    ids_j = np.asarray(jtopo.knn_topology(jnp.asarray(X), jnp.asarray(m), k=64,
                                          method="exact")[0])
    ids = ids.numpy()
    np.testing.assert_array_equal(ok.numpy(), ids_j != 0)
    same = ids == ids_j
    rows = np.nonzero(~same.all(axis=1))[0]
    if len(rows):
        Xc = X.astype(np.float64)
        sq_max = float(np.max(np.sum(X[m > 0] ** 2, axis=1)) * 4)
        dt = np.sum((Xc[ids[rows]] - Xc[rows, None]) ** 2, axis=-1)
        dj = np.sum((Xc[ids_j[rows]] - Xc[rows, None]) ** 2, axis=-1)
        assert np.abs(dt - dj).max() <= 8 * 1.2e-7 * sq_max + 1e-6
    return len(rows)


def _lattice():
    g = np.arange(10, dtype=np.float32) * 1.5
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _cluster_outliers():
    rng = np.random.RandomState(4)
    core = rng.randn(800, 3).astype(np.float32) * 2.0
    far = (rng.rand(24, 3) * 2 - 1).astype(np.float32) * 150.0
    return np.concatenate([core[:400], far, core[400:]])


def _chain():
    t = np.arange(600, dtype=np.float32)[:, None]
    return (t * np.array([[0.6, 0.8, 0.0]], np.float32) + 5.0).astype(np.float32)


def _duplicates():
    rng = np.random.RandomState(5)
    X = (rng.rand(700, 3) * 20).astype(np.float32)
    X[100:180] = X[7]  # 81 atoms on one point; in [90:190] the 64th is pushed
    X[300:303] = X[600]
    return X


def _cloud(n, seed):
    return random_structure_arrays(n_atoms=n, n_res=max(n // 8, 4), seed=seed)[0]


CASES = {
    "lattice1000": lambda: _padded([_lattice()], 1024),
    "cluster_outliers": lambda: _padded([_cluster_outliers()], 1024),
    "colinear600": lambda: _padded([_chain()], 640),
    "duplicates700": lambda: _padded([_duplicates()], 1024),
    "duplicates_heavy100": lambda: _padded([_duplicates()[90:190]], 128),
    "n_le_k50": lambda: _padded([_cloud(50, 3)], 640),
    "sink_padding60": lambda: _padded([(np.random.RandomState(3).rand(60, 3) * 30)
                                       .astype(np.float32)], 128),
    "file_order3000": lambda: _padded([_cloud(3000, 8)], 4096),
    "golden": lambda: _padded([jax_read_pdb(GOLDEN)["xyz"]], 4096),
}


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_plain_and_jax(name, record_property):
    X, m = CASES[name]()
    xc4 = knn.center_coords(torch.from_numpy(X), torch.from_numpy(m))
    ids, ok, stats = emulate(xc4)
    ids_p, ok_p, _ = knn.knn_plain(xc4)
    assert torch.equal(ids, ids_p) and torch.equal(ok, ok_p)
    ties = _assert_ids_match_jax(X[0], m[0], ids[0], ok[0])
    n = int(m.sum())
    record_property("tie_rows_vs_jax", ties)
    record_property("pairs_share", stats["pairs"] / n**2)
    record_property("largest_fill", stats["fill"])
    assert stats["fill"] <= knn.SLOTS
    if name == "file_order3000":  # tiles are skipped where the cloud is large
        assert stats["pairs"] < 0.5 * n * n


def test_batch_of_three_structures():
    X, m = _padded([_cloud(600, 0), _cloud(450, 1), _cloud(40, 2)], 640)
    xc4 = knn.center_coords(torch.from_numpy(X), torch.from_numpy(m))
    ids, ok, _ = emulate(xc4)
    ids_p, ok_p, _ = knn.knn_plain(xc4)
    assert torch.equal(ids, ids_p) and torch.equal(ok, ok_p)
    for b in range(3):
        _assert_ids_match_jax(X[b], m[b], ids[b], ok[b])


def test_small_buffer_cuts_the_rows_and_keeps_the_ids():
    X, m = _padded([_cloud(900, 7)], 1024)
    xc4 = knn.center_coords(torch.from_numpy(X), torch.from_numpy(m))
    # 96 slots: a buffer is cut as soon as it holds more than 64 keys
    ids, ok, stats = emulate(xc4, slots=knn.K + knn.TILE)
    assert stats["cut_rows"] > 0.8 * 900 and stats["cuts"] > 900
    ids_p, ok_p, _ = knn.knn_plain(xc4)
    assert torch.equal(ids, ids_p) and torch.equal(ok, ok_p)


@pytest.mark.parametrize("name", ["lattice1000", "cluster_outliers", "colinear600", "golden"])
def test_prune_margin_covers_the_gram_rounding(name):
    """Exact squared distance minus the kernel's fp32 Gram value (fused
    multiply-adds, emulated in float64) and minus knn_plain's, over every
    valid pair, stay within the margin the prune test adds."""
    X, m = CASES[name]()
    xc4 = knn.center_coords(torch.from_numpy(X), torch.from_numpy(m))[0]
    x = xc4[xc4[:, 3] >= 0]
    p, w = x[:, :3].double(), x[:, 3].double()
    exact = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)

    def f32(t):
        return t.float().double()

    dot = f32(p[:, None, 0] * p[None, :, 0])
    dot = f32(p[:, None, 1] * p[None, :, 1] + dot)
    dot = f32(p[:, None, 2] * p[None, :, 2] + dot)
    fused = f32(f32(w[:, None] + w[None, :]) - 2 * dot).clamp_min(0)
    plain = (w[:, None] + w[None, :] - 2.0 * (x[:, :3] @ x[:, :3].T).double()).float().double()
    margin = knn.MARGIN_REL * (w[:, None] + w[None, :]) + knn.MARGIN_ABS
    for gram in (fused, plain.clamp_min(0)):
        assert (exact - gram - margin).max() <= 0


@pytest.mark.parametrize("name", ["cluster_outliers", "lattice1000", "duplicates700", "golden"])
def test_morton_keys_order_like_pesto_tpu(name):
    X, m = CASES[name]()
    n = int(m.sum())
    w = np.where(m > 0, 1.0, -1.0).astype(np.float32)[..., None]  # w < 0: sink, padding
    keys = knn.morton_keys_plain(torch.from_numpy(np.concatenate([X, w], -1)))
    perm = torch.sort(keys, dim=1, stable=True).indices[0].numpy()
    np.testing.assert_array_equal(perm[:n], 1 + morton_order(X[0, 1 : n + 1]))
    assert set(perm[n:].tolist()) == {0, *range(n + 1, X.shape[1])}  # sink, padding last


def _cu_constants():
    """The `constexpr` int and float scalars that csrc/knn.cu declares,
    evaluated in order: {name: value}."""
    import re

    src = pathlib.Path(knn.__file__).resolve().parent.parent / "csrc" / "knn.cu"
    found = {}
    for name, expr in re.findall(r"^constexpr (?:int|float) (\w+) = ([^;]+);", src.read_text(),
                                 re.M):
        expr = re.sub(r"(\d)f\b", r"\1", expr)
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    return found


@pytest.mark.parametrize("name", ["K", "PREP", "TILE", "GROUP", "WINDOW", "SLOTS", "MARGIN_REL",
                                  "MARGIN_ABS", "INVALID_KEY", "PUSH", "BIGHALF"])
def test_schedule_constants_match_the_kernel(name):
    """ops/knn.py and the emulation above use the schedule that csrc/knn.cu
    runs."""
    cu = _cu_constants()
    assert name in cu, f"csrc/knn.cu declares no constexpr {name}"
    assert cu[name] == pytest.approx(getattr(knn, name), rel=1e-7)
