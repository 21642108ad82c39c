"""The dimer's batched path on the CPU: `CrossPestoModel` over a batch of
pairs, the cross-attention op (`ops.cross_attention`) and
`Predictor.predict_pairs`, held against the benchmark's plain reference
(`h100bench/reference/cross.py`) and the port's one-pair call, which
tests/test_torch_cross.py holds against the JAX package. Seeded weights,
nn cut to [8, 16]."""

import json
import os

import numpy as np
import pytest
import torch

from h100bench import common, structures
from h100bench.reference import cross as rc
from h100bench.reference import pesto as ref
from pesto_tpu_torch import infer
from pesto_tpu_torch.batching import RES_BUCKETS, pad_structure_arrays, stack_batch
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.models import CrossPestoModel, extras
from pesto_tpu_torch.models import pesto as port_pesto
from pesto_tpu_torch.ops import _build
from pesto_tpu_torch.ops import cross_attention as ca
from pesto_tpu_torch.ops import edge_attention, knn
from pesto_tpu_torch.ops.knn import knn_ids
from pesto_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 21
LOGIT_ATOL = 1e-5  # float32 sums in another order (batched table, blocked softmax)
PROB_ATOL = 2e-6  # as the benchmark's test of the single-structure model
OP_ATOL = 1e-6  # the op's rows against the reference's, float32 softmax sums in another order


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(ROOT, "h100bench", "configs", "pesto_cross_i_v4_1.json")) as f:
        return dict(json.load(f), nn=[8, 16])


@pytest.fixture(scope="module")
def weights(cfg):
    return rc.make_weights(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def model(cfg, weights):
    m = CrossPestoModel(common.program_config(cfg))
    m.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def reference(cfg, weights):
    m = rc.CrossModel(cfg)
    m.load_state_dict(weights)
    return m.eval()


@pytest.fixture(scope="module")
def recs():
    return structures.make_records(5, 6, 20, 0.4, 10, 30)


def _padded(rec, cfg, na, nr, compact):
    q = ref.features(rec, cfg).numpy()
    res, n_res = ref.residues(rec)
    M = (res.numpy()[:, None] == np.arange(n_res)).astype(np.float32)
    return pad_structure_arrays(rec["xyz"], q, M, na=na, nr=nr, compact=compact)


def _side(recs, cfg, na, nr, compact):
    """A batch of one side: (X, ids, q, M, atom_mask) tensors, the kNN by the
    port's plain version."""
    b = stack_batch([_padded(r, cfg, na, nr, compact) for r in recs])
    X, am = torch.as_tensor(b.X), torch.as_tensor(b.atom_mask)
    ids, _ = knn_ids(X, am)
    return (X, ids, torch.as_tensor(b.q), torch.as_tensor(b.M), am)


def _reference_logits(reference, cfg, pair, ids_pair):
    sides = [rc.side(reference, r["xyz"], i, ref.features(r, cfg), *ref.residues(r), "cpu")
             for r, i in zip(pair, ids_pair)]
    with torch.no_grad():
        return reference(*sides)


def _pairs(recs):
    # unequal sizes on both sides; the larger chain on either side
    return [(recs[0], recs[1]), (recs[2], recs[3]), (recs[4], recs[5])]


def test_the_batched_dimer_matches_the_reference_and_the_one_pair_call(cfg, model, reference, recs):
    pairs = _pairs(recs)
    na_a, na_b, nr = 320, 288, 32
    assert max(len(a["xyz"]) for a, _ in pairs) < na_a - 1 and max(len(b["xyz"]) for _, b in pairs) < na_b - 1
    A, B = (_side([p[k] for p in pairs], cfg, na, nr, compact=True) for k, na in ((0, na_a), (1, na_b)))
    with torch.no_grad():
        zA, zB = model(A, B, nr_a=nr, nr_b=nr)
    assert zA.shape == (3, nr, 5) and zB.shape == (3, nr, 5)
    dA, dB = (_side([p[k] for p in pairs], cfg, na, nr, compact=False) for k, na in ((0, na_a), (1, na_b)))
    for b, pair in enumerate(pairs):
        n = [len(r["xyz"]) for r in pair]
        r_ = [int(r["resid"].max()) for r in pair]
        ids = [side[1][b, 1 : k + 1].long() - 1 for side, k in zip((A, B), n)]
        want = _reference_logits(reference, cfg, pair, ids)
        for got, w, k in zip((zA[b], zB[b]), want, r_):
            assert torch.abs(got[:k] - w).max() < LOGIT_ATOL
        # the one-pair call on the same padded rows
        with torch.no_grad():
            one = model(tuple(t[b] for t in dA), tuple(t[b] for t in dB))
        for got, w, k in zip((zA[b], zB[b]), one, r_):
            assert torch.abs(got[:k] - w[:k]).max() < LOGIT_ATOL


def test_the_batched_dimer_runs_one_edge_and_one_cross_attention_a_layer(cfg, model, recs, monkeypatch):
    calls = {"edge": [], "cross": []}
    edge, cross = port_pesto.fused_edge_attention, extras.cross_attention

    def count_edge(*a, **kw):
        calls["edge"].append(a[1].shape)
        return edge(*a, **kw)

    def count_cross(*a, **kw):
        calls["cross"].append(a[0].shape[0])
        return cross(*a, **kw)

    monkeypatch.setattr(port_pesto, "fused_edge_attention", count_edge)
    monkeypatch.setattr(extras, "cross_attention", count_cross)
    pairs = _pairs(recs)
    A, B = (_side([p[k] for p in pairs], cfg, 320, 32, compact=True) for k in (0, 1))
    with torch.no_grad():
        model(A, B, nr_a=32, nr_b=32)
    rows = 3 * 320 * 2
    assert calls["edge"] == [(rows, 8), (rows, 16)] and calls["cross"] == [rows, rows]


def test_the_plain_op_matches_the_reference_attention():
    """Segments with padding rows between them (garbage that must not
    count), a one-atom partner, and a segment whose partner is itself."""
    g = torch.Generator().manual_seed(3)
    N = 40
    Q = torch.randn(N, 2, 3, generator=g) * 2
    K = torch.randn(N, 3, generator=g) * 2
    V = torch.randn(N, 32, generator=g)
    offsets, counts, partner = [1, 12, 30, 36], [9, 15, 1, 3], [1, 0, 0, 2]
    for t in (Q, K, V):  # the rows no segment holds
        for r in (0, 10, 11, 27, 28, 29, 31, 32, 33, 34, 35, 39):
            t[r] = 1e4
    got = ca.cross_attention(Q, K, V, torch.tensor(offsets, dtype=torch.int32), torch.tensor(counts),
                             torch.tensor(partner), max(counts))
    assert got.shape == (N, 64)
    held = torch.zeros(N, dtype=torch.bool)
    for o, c, t in zip(offsets, counts, partner):
        keys = slice(offsets[t], offsets[t] + counts[t])
        want = rc.cross_attention(Q[o : o + c], K[keys], V[keys])
        assert torch.abs(got[o : o + c] - want).max() < OP_ATOL
        held[o : o + c] = True
    assert (got[~held] == 0).all()
    # the blocks of the plain version do not change its rows
    small = ca.PLAIN_BLOCK
    try:
        ca.PLAIN_BLOCK = 7
        again = ca.cross_attention_plain(Q, K, V, offsets, counts, partner)
    finally:
        ca.PLAIN_BLOCK = small
    assert torch.abs(again - got).max() < OP_ATOL
    # the padded, biased form of the JAX package gives the same rows
    bias = torch.full((N,), -1e6)
    bias[offsets[0] : offsets[0] + counts[0]] = 0.0
    w = torch.softmax(torch.einsum("nhk,mk->nhm", Q[12:27], K / 3**0.5) + bias, dim=2)
    assert torch.abs(got[12:27] - torch.einsum("nhm,ms->nhs", w, V).reshape(15, 64)).max() < OP_ATOL


def test_the_kernel_refuses_cpu_tensors():
    Q = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ca.cross_attention_kernel(Q, torch.zeros(4, 3), torch.zeros(4, 32), *(torch.zeros(1, dtype=torch.int32),) * 3, 1)


@pytest.fixture(scope="module")
def pred(cfg, weights):
    return Predictor(common.program_config(cfg), {k: v.clone() for k, v in weights.items()}, device="cpu")


def _port_ids(X):
    n = len(X)
    Xp = torch.zeros(1, n + 1, 3)
    Xp[0, 1:] = torch.as_tensor(X)
    am = torch.zeros(1, n + 1)
    am[0, 1:] = 1
    return knn_ids(Xp, am)[0][0, 1:].long() - 1


def test_predict_pairs_matches_the_reference_in_order(cfg, pred, reference, recs):
    bad = dict(recs[2])
    del bad["resid"]  # cannot be encoded
    pairs = [(recs[0], recs[1]), (recs[3], recs[0]), (bad, recs[4]), (recs[5], recs[4]), (recs[1], recs[1])]
    out = pred.predict_pairs(pairs, atoms_per_call=700)
    assert out[2] is None
    for pair, got in zip(pairs, out):
        if got is None:
            continue
        want = _reference_logits(reference, cfg, pair, [_port_ids(r["xyz"]) for r in pair])
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - torch.sigmoid(w).numpy()).max() < PROB_ATOL
    # a chain's answer depends on its partner
    assert np.abs(out[0][0] - out[1][1]).max() > 1e-4
    with pytest.raises(TypeError, match="predict_pairs"):
        pred.predict_batch([recs[0]])


def test_predict_pairs_gives_none_for_a_side_past_the_largest_bucket(pred, recs):
    """A record over the largest residue bucket, on either side and larger
    than its partner, gives its pair None; the pair beside it is answered
    as alone."""
    n = RES_BUCKETS[-1] + 16
    big = {k: np.resize(v, (n,) + v.shape[1:]) for k, v in recs[0].items()}
    big["resid"] = np.arange(1, n + 1)
    pairs = [(recs[2], big), (recs[0], recs[1]), (big, recs[3])]
    out = pred.predict_pairs(pairs, atoms_per_call=700)
    assert out[0] is None and out[2] is None
    (alone,) = pred.predict_pairs([pairs[1]], atoms_per_call=700)
    for got, want in zip(out[1], alone):
        assert np.array_equal(got, want)


def test_predict_pairs_spans_carry_their_attributes(pred, recs, monkeypatch):
    """While recording: the call, its stages and per chunk the buckets, the
    real pairs and the launch counters' deltas (counting stand-ins for the
    three kernels); stage_ms gains the stages' lengths."""
    knn_plain_ids, edge, cross = infer.knn_ids, port_pesto.fused_edge_attention, extras.cross_attention

    def counting(fn, kernel):
        def wrapped(*a, **kw):
            _build.count_launch(kernel)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(infer, "knn_ids", counting(knn_plain_ids, knn.knn_kernel))
    monkeypatch.setattr(port_pesto, "fused_edge_attention", counting(edge, edge_attention.edge_attention_kernel))
    monkeypatch.setattr(extras, "cross_attention", counting(cross, ca.cross_attention_kernel))
    pairs = [(recs[0], recs[1]), (recs[2], recs[3]), (recs[4], recs[5]), (recs[1], recs[0])]
    tracing.take()
    before = dict(pred.stage_ms)
    with tracing.record():
        out = pred.predict_pairs(pairs, atoms_per_call=600)
    spans = tracing.take().spans
    assert all(o is not None for o in out)
    (call,) = [s for s in spans if s.name == "predict_pairs"]
    assert call.attrs == {"pairs": len(pairs)}
    assert len([s for s in spans if s.name == "predict_pairs.plan"]) == 1
    sizing, *encs = sorted((s for s in spans if s.name == "predict_pairs.record_encode"), key=lambda s: s.start_ns)
    assert sizing.attrs["records"] == 6 and sizing.attrs["in_flight"] == 0  # the sizes of each distinct record
    records = [s for s in spans if s.name == "predict_pairs.encode_record"]
    assert len(records) == 6  # each distinct record once
    assert sum(e.attrs["records"] for e in encs) == 6 and encs[0].attrs["in_flight"] == 0
    assert {r.parent_id for r in records} <= {e.span_id for e in encs}
    assert all(s.thread == call.thread for s in encs + records)
    chunks = sorted((s for s in spans if s.name == "predict_pairs.batch_encode"), key=lambda s: s.start_ns)
    assert len(encs) == len(chunks) and all(e.end_ns <= c.start_ns for e, c in zip(encs, chunks))
    launches = [s for s in spans if s.name == "predict_pairs.launch"]
    assert len(chunks) == len(launches) == len([s for s in spans if s.name == "predict_pairs.collect"]) >= 2
    sizes = [sorted((len(a["xyz"]), len(b["xyz"]))) for a, b in pairs]
    assert sum(c.attrs["B"] for c in chunks) == len(pairs)
    assert sum(c.attrs["real_atoms"] for c in chunks) == sum(a + b for a, b in sizes)
    assert sum(c.attrs["real_pairs"] for c in chunks) == sum(a * b for a, b in sizes)
    for c in chunks:
        assert c.attrs["call"] == call.span_id
        assert c.attrs["padded_atoms"] == c.attrs["B"] * (c.attrs["na_a"] + c.attrs["na_b"])
        assert c.attrs["na_a"] >= c.attrs["na_b"] and c.attrs["h2d_bytes"] == 0 and c.attrs["nr_a"] >= 32
    for s in launches:  # 2 kNN (one a side), one edge and one cross attention a layer
        assert (s.attrs["knn_launches"], s.attrs["edge_launches"], s.attrs["cross_launches"]) == (2, 2, 2)
    stages = {"record_encode": "predict_pairs.record_encode", "batch_encode": "predict_pairs.batch_encode",
              "device_wait": "predict_pairs.collect"}
    for key, name in stages.items():
        want = sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6
        assert pred.stage_ms[key] - before[key] == pytest.approx(want, rel=1e-9, abs=1e-9)
    assert pred.stage_ms["batch_calls"] == before["batch_calls"] + 1


def test_predict_pairs_codes_a_shared_chain_once_across_chunks(pred, recs):
    """A chain in two pairs that fall in different chunks (one pair a
    chunk): its codes are made once, with the first chunk, under one
    `.encode_record` span; each pair's answer is its answer alone."""
    pairs = [(recs[0], recs[1]), (recs[2], recs[0]), (recs[3], recs[4])]
    with tracing.record():
        out = pred.predict_pairs(pairs, atoms_per_call=256)
    spans = tracing.take().spans
    chunks = [s for s in spans if s.name == "predict_pairs.batch_encode"]
    assert len(chunks) == 3 and all(c.attrs["B"] == 1 for c in chunks)
    records = [s.attrs["structure"] for s in spans if s.name == "predict_pairs.encode_record"]
    assert sorted(records) == [0, 1, 2, 3, 4]  # recs[0] is distinct record 0
    encs = sorted((s for s in spans if s.name == "predict_pairs.record_encode"), key=lambda s: s.start_ns)
    assert [e.attrs["records"] for e in encs] == [5, 2, 1, 2]
    for pair, got in zip(pairs, out):
        (alone,) = pred.predict_pairs([pair], atoms_per_call=256)
        for g, w in zip(got, alone):
            assert np.array_equal(g, w)


def test_the_kernels_function_takes_the_plain_versions_gradient(monkeypatch):
    """CrossAttentionFunction (the card's path under autograd) with a
    stand-in for the kernel that keeps no history: its backward, the plain
    version rerun under autograd, gives autograd's gradients of the plain
    version (the same arithmetic: equal to float32 rounding)."""
    monkeypatch.setattr(ca, "cross_attention_kernel",
                        lambda Q, K, V, o, c, p, m: ca.cross_attention_plain(Q, K, V, o, c, p).detach())
    g = torch.Generator().manual_seed(5)
    N = 30
    leaves = [torch.randn(shape, generator=g, requires_grad=True) for shape in ((N, 2, 3), (N, 3), (N, 32))]
    segs = [torch.tensor(x, dtype=torch.int32) for x in ([1, 16], [12, 9], [1, 0])]
    w = torch.randn(N, 64, generator=g)
    (ca.CrossAttentionFunction.apply(*leaves, *segs, 12) * w).sum().backward()
    got = [x.grad.clone() for x in leaves]
    for x in leaves:
        x.grad = None
    (ca.cross_attention_plain(*leaves, *segs) * w).sum().backward()
    for a, x in zip(got, leaves):
        assert torch.allclose(a, x.grad, rtol=1e-6, atol=1e-7)
    assert got[0][0].abs().sum() == 0 and got[0][13:16].abs().sum() == 0  # rows outside the segments
