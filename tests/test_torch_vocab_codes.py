"""Integer feature codes on the Predictor's batched path, held against the
dense one-hot path on the CPU.

Records of three vocabularies (i_v3_0: elements, residue names, atom names)
and of one (i_v4_1) encode to [n, V] codes, each column offset into the
concatenated one-hot; BatchEncoder fills [B, na, V] int32 buffers, in a
buffer set of their own; `onehot_codes` expands them into exactly the dense
features; and predict_batch's probabilities equal, bit for bit, those of the
same chunks encoded densely and run through the same model."""

import pathlib

import numpy as np
import pytest
import torch

from pesto_tpu_torch import batching
from pesto_tpu_torch.encoding import encode_features, encode_structure, std_elements, std_names, std_resnames
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.io import read_structure
from pesto_tpu_torch.models import PestoModel, get_config
from pesto_tpu_torch.models.pesto import onehot_codes
from pesto_tpu_torch.structure import concatenate_chains, preprocess_structure
from pesto_tpu_torch.synthetic import random_structure_record
from pesto_tpu_torch.utils import tracing

SIZES = (40, 300, 700, 650, 120, 900, 260)  # three atom buckets, chunks of one and of two
GOLDEN = str(pathlib.Path(__file__).resolve().parent / "goldens" / "1OL5_A_i0.pdb")


def _predictor(variant):
    cfg = get_config(variant)
    cfg = cfg.replace(layers=(cfg.layers[0], cfg.layers[-1]))
    torch.manual_seed(11)
    return Predictor(cfg, PestoModel(cfg).state_dict(), device="cpu")


@pytest.fixture(scope="module", params=["i_v3_0", "i_v4_1"])  # three vocabularies, one
def pred(request):
    return _predictor(request.param)


def _record(n, seed):
    """A record with every vocabulary's names drawn at random, one unknown
    element, residue name and atom name (each its vocabulary's "other"
    column), and residue numbers with gaps."""
    rec = random_structure_record(n_atoms=n, n_res=max(n // 8, 3), seed=seed)
    rng = np.random.RandomState(seed + 100)
    rec["element"] = std_elements[rng.randint(0, len(std_elements), n)].astype("<U3")
    rec["resname"] = std_resnames[rng.randint(0, len(std_resnames), n)].astype("<U4")
    rec["name"] = std_names[rng.randint(0, len(std_names), n)].astype("<U4")
    rec["element"][1], rec["resname"][2], rec["name"][3] = "Xx", "ZZZ", "QQ1"
    rec["resid"] = rec["resid"] * 3 + 7
    return rec


def _records():
    return [_record(n, seed=i) for i, n in enumerate(SIZES)]


def _dense_item(pred, rec):
    """The dense host arrays of a record: (X, one-hot features [n, F] of
    the config's flags, residue membership [n, n_res])."""
    X, M = encode_structure(rec)
    q = np.concatenate([f for f, flag in zip(encode_features(rec), pred.cfg.feature_flags) if flag], axis=1)
    return X, q, M


def test_record_codes_expand_to_the_dense_one_hot(pred):
    V = sum(pred.cfg.feature_flags)
    for rec in _records():
        X, codes, rid, n_res = batching.encode_record(rec, pred.cfg)
        Xd, q, M = _dense_item(pred, rec)
        assert codes.shape == (len(X), V) and codes.dtype == rid.dtype == np.int32
        np.testing.assert_array_equal(X, Xd)
        assert n_res == M.shape[1] < int(rec["resid"].max())  # gaps in the numbering
        np.testing.assert_array_equal(onehot_codes(torch.from_numpy(codes)[None], pred.cfg.em_n0)[0].numpy(), q)
        np.testing.assert_array_equal(onehot_codes(torch.from_numpy(rid)[None], n_res)[0].numpy(), M)
    # each unknown name goes to its vocabulary's "other" column
    other = np.cumsum([len(v) + 1 for v in (std_elements, std_resnames, std_names)]) - 1
    codes = batching.encode_record(_records()[0], pred.cfg)[1]
    assert [codes[1 + k, k] for k in range(V)] == list(other[:V])


def test_encode_record_joins_the_sizes_and_the_codes(pred):
    """encode_record is record_codes (X, codes) joined with record_sizes'
    residue codes and n_res; record_sizes' atom count gives the same
    buckets as the encoded record."""
    for rec in _records() + [concatenate_chains(preprocess_structure(read_structure(GOLDEN)))]:
        X, codes, rid, n_res = batching.encode_record(rec, pred.cfg)
        n, rid_s, n_res_s = batching.record_sizes(rec)
        Xc, codes_c = batching.record_codes(rec, pred.cfg)
        assert n == len(X) and n_res_s == n_res and rid_s.dtype == rid.dtype == np.int32
        for got, want in ((Xc, X), (codes_c, codes), (rid_s, rid)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert batching.size_buckets(n, n_res_s) == batching.record_buckets((X, codes, rid, n_res))


def test_predict_batch_codes_equal_the_dense_path(pred, monkeypatch):
    """predict_batch's answers, bit for bit, against the same chunks'
    dense BatchEncoder items (float32 one-hots and membership) through
    the same model."""
    recs = _records()
    by_atoms = {len(r["xyz"]): i for i, r in enumerate(recs)}
    chunks, encode = [], batching.BatchEncoder.encode

    def spy(self, items, na, nr, **kw):
        chunks.append(([by_atoms[len(it[0])] for it in items], na, nr))
        return encode(self, items, na, nr, **kw)

    monkeypatch.setattr(batching.BatchEncoder, "encode", spy)
    got = pred.predict_batch(recs, atoms_per_call=2048)
    monkeypatch.undo()
    assert sum(len(c[0]) for c in chunks) == len(recs) and max(len(c[0]) for c in chunks) == 2

    dense = batching.BatchEncoder(2)
    try:
        for idx, na, nr in chunks:
            b = dense.encode([_dense_item(pred, recs[i]) for i in idx], na=na, nr=nr)
            assert b.q.dtype == np.float32 and b.q.shape == (len(idx), na, pred.cfg.em_n0)
            (probs,) = pred._forward((*(torch.from_numpy(t) for t in (b.X, b.q, b.M, b.atom_mask)), None))
            for j, i in enumerate(idx):
                want = probs[j].numpy()[: len(np.unique(recs[i]["resid"]))]
                assert got[i].shape == want.shape and np.array_equal(got[i], want)
    finally:
        dense.close()


def test_batch_encoder_fills_codes_of_each_vocabulary_count():
    """Three-vocabulary codes fill [B, na, 3] int32, one-vocabulary codes
    [B, na, 1], each in a buffer set of its own; X, the residue codes and
    the atom mask equal between them; expanded, the codes are the dense
    buffer's features and membership on every real row."""
    p3, p1 = _predictor("i_v3_0"), _predictor("i_v4_1")
    recs = [_record(n, seed=i) for i, n in enumerate((40, 300, 700, 650))]
    enc = batching.BatchEncoder(2)
    try:
        b3 = enc.encode([batching.encode_record(r, p3.cfg) for r in recs], na=1024, nr=128)
        b1 = enc.encode([batching.encode_record(r, p1.cfg) for r in recs], na=1024, nr=128)
        bd = enc.encode([_dense_item(p3, r) for r in recs], na=1024, nr=128)
        assert b3.q.shape == (4, 1024, 3) and b1.q.shape == (4, 1024, 1)
        assert b3.q.dtype == b1.q.dtype == b3.M.dtype == np.int32 and b3.M.shape == (4, 1024)
        for f in ("X", "M", "atom_mask"):
            np.testing.assert_array_equal(getattr(b3, f), getattr(b1, f), err_msg=f)
        assert b3.q.ctypes.data != b1.q.ctypes.data and b3.X.ctypes.data != b1.X.ctypes.data
        assert sorted(k[3:] for k in enc._sigs) == [(False, (123,)), (True, (1,)), (True, (3,))]
        real = bd.atom_mask > 0
        q = onehot_codes(torch.from_numpy(b3.q), 123).numpy()
        M = onehot_codes(torch.from_numpy(b3.M), 128).numpy() * bd.atom_mask[..., None]
        np.testing.assert_array_equal(q[real], bd.q[real])
        np.testing.assert_array_equal(M, bd.M)
        assert not bd.q[~real].any() and not b3.q[~real].any()  # sink and padding: code 0, masked
    finally:
        enc.close()


def test_batch_encode_span_counts_the_codes(pred):
    with tracing.record():
        out = pred.predict_batch(_records()[:3], atoms_per_call=1024)
    assert all(o is not None for o in out)
    chunks = [s for s in tracing.take().spans if s.name == "predict_batch.batch_encode"]
    assert chunks and {s.attrs["codes"] for s in chunks} == {sum(pred.cfg.feature_flags)}


def test_predict_structure_codes_equal_the_dense_inputs(pred):
    """predict_structure (the record's codes padded by `batching.pad_record`)
    gives, at tolerance 0, the probabilities of the dense one-hot and
    membership of `encode_and_pad` through the same Predictor."""
    rec = concatenate_chains(preprocess_structure(read_structure(GOLDEN)))
    ps = batching.encode_and_pad(rec, feature_flags=pred.cfg.feature_flags, device="cpu")
    n_res = int(np.sum(ps.res_mask))
    want = pred.probabilities(ps)[:n_res]
    got = pred.predict_structure(rec)
    assert got.shape == want.shape == (n_res, pred.cfg.dm_n2)
    np.testing.assert_array_equal(got, want)


def test_pad_record_fills_the_batch_encoders_rows(pred):
    """pad_record's arrays are the rows that BatchEncoder fills for the same
    record in its buckets (`record_buckets`), sink and padding included."""
    enc = batching.BatchEncoder(2)
    try:
        for rec in _records()[:4]:
            item = batching.encode_record(rec, pred.cfg)
            Xp, qp, Mp, am, n_res, nr = batching.pad_record(item)
            assert (Xp.shape[0], nr) == batching.record_buckets(item) and n_res == item[3]
            b = enc.encode([item], na=Xp.shape[0], nr=nr)
            for name, got, want in zip("XqMa", (Xp, qp, Mp, am), (b.X[0], b.q[0], b.M[0], b.atom_mask[0])):
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
    finally:
        enc.close()
