"""The record encode of `Predictor.predict_batch` on the CPU: the plan made
from each record's sizes (`batching.record_sizes`) gives the chunks that
encoding every record first gives, in the same order; the codes made as
each chunk is submitted give the same probabilities; and a record whose
codes fail at its chunk leaves the chunk and gives None alone."""

import numpy as np
import pytest
import torch

from pesto_tpu_torch import batching
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.models import PestoModel, get_config
from pesto_tpu_torch.synthetic import random_structure_record
from pesto_tpu_torch.utils import tracing

# atom buckets 256, 512 and 1024, residue buckets 32 to 256: six keys, eight chunks at 1024 atoms
SIZES = (40, 300, 700, 650, 120, 900, 260, 230, 480, 90, 610, 200)


@pytest.fixture(scope="module")
def pred():
    cfg = get_config("i_v4_1")
    cfg = cfg.replace(layers=(cfg.layers[0], cfg.layers[-1]))
    torch.manual_seed(12)
    return Predictor(cfg, PestoModel(cfg).state_dict(), device="cpu")


def _records():
    return [random_structure_record(n_atoms=n, n_res=max(n // 6, 3), seed=40 + i) for i, n in enumerate(SIZES)]


def _encode_first_plan(recs, cfg, atoms_per_call):
    """The chunks as records encoded before the plan gave them: [(record
    indices, na, nr)] in submission order (every record encoded, keyed by
    `record_buckets`, a key's records in first-seen order, at most
    atoms_per_call padded atoms a chunk)."""
    groups = {}
    for i, rec in enumerate(recs):
        groups.setdefault(batching.record_buckets(batching.encode_record(rec, cfg)), []).append(i)
    chunks = []
    for (na, nr), idx in groups.items():
        bmax = max(1, atoms_per_call // na)
        chunks += [(idx[k : k + bmax], na, nr) for k in range(0, len(idx), bmax)]
    return chunks


def _chunks(spans):
    return [(s.attrs["B"], s.attrs["na"], s.attrs["nr"])
            for s in sorted(spans, key=lambda s: s.start_ns) if s.name == "predict_batch.batch_encode"]


def test_predict_batch_plans_the_encode_first_chunks_and_answers_bit_for_bit(pred):
    recs = _records()
    want = _encode_first_plan(recs, pred.cfg, atoms_per_call=1024)
    assert len(want) >= 4 and len({(na, nr) for _, na, nr in want}) >= 3
    with tracing.record():
        got = pred.predict_batch(recs, atoms_per_call=1024)
    assert _chunks(tracing.take().spans) == [(len(idx), na, nr) for idx, na, nr in want]
    for i, rec in enumerate(recs):
        alone = pred.predict_structure(rec)
        assert got[i].shape == alone.shape and np.array_equal(got[i], alone), i
    # the same chunks, their records encoded first, through one BatchEncoder and the forward
    enc = batching.BatchEncoder(2)
    try:
        for idx, na, nr in want:
            b = enc.encode([batching.encode_record(recs[i], pred.cfg) for i in idx], na=na, nr=nr)
            (probs,) = pred._forward((*(torch.from_numpy(t) for t in (b.X, b.q, b.M, b.atom_mask)), nr))
            for j, i in enumerate(idx):
                assert np.array_equal(got[i], probs[j].numpy()[: len(got[i])]), i
    finally:
        enc.close()


def test_a_record_whose_codes_fail_leaves_its_chunk(pred, capsys):
    """Its xyz and resid size it; its element column, two names short,
    fails the codes when its chunk is submitted: None and an EncodeError
    line for it, its chunk one record smaller, every other record
    answered as without it."""
    recs = _records()
    bad = dict(recs[1], element=recs[1]["element"][:-2])
    batching.record_sizes(bad)
    with pytest.raises(ValueError):
        batching.record_codes(bad, pred.cfg)
    with tracing.record():
        got = pred.predict_batch(recs[:1] + [bad] + recs[2:], atoms_per_call=1024)
    spans = tracing.take().spans
    assert got[1] is None
    assert "EncodeError: structure 1" in capsys.readouterr().err
    want = pred.predict_batch(recs, atoms_per_call=1024)
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 1:
            assert np.array_equal(g, w), i
    plan = _encode_first_plan(recs, pred.cfg, atoms_per_call=1024)
    assert [len(idx) for idx, _, _ in plan if 1 in idx] == [2]
    assert _chunks(spans) == [(len(idx) - (1 in idx), na, nr) for idx, na, nr in plan]
    encs = [s for s in spans if s.name == "predict_batch.record_encode"]
    assert encs[0].attrs["records"] == len(recs) and sum(s.attrs["records"] for s in encs[1:]) == len(recs)


def test_a_chunk_of_records_whose_codes_all_fail_launches_nothing(pred, capsys):
    recs = _records()
    bad = [dict(r, element=r["element"][:-1]) for r in recs[:2]]
    with tracing.record():
        got = pred.predict_batch(bad + recs[2:3], atoms_per_call=256)
    spans = tracing.take().spans
    assert got[0] is None and got[1] is None and np.array_equal(got[2], pred.predict_structure(recs[2]))
    err = capsys.readouterr().err
    assert "EncodeError: structure 0" in err and "EncodeError: structure 1" in err
    assert _chunks(spans) == [(1, 1024, 128)]
    assert len([s for s in spans if s.name == "predict_batch.launch"]) == 1
