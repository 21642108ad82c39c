"""The span recorder (`pesto_tpu_torch.utils.tracing`) on the CPU: when it
records, the spans of `Predictor.predict_batch` and their parents (the
record encode among them, on the caller's thread), its buffer and cap, the stage totals it keeps
always, its clock against the profiler's, the launch stamps of
`ops._build.Entry`, and the spans in `device_trace`'s Chrome trace."""

import json
import time

import pytest
import torch

from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.models import get_config
from pesto_tpu_torch.ops import _build
from pesto_tpu_torch.port import init_state_dict
from pesto_tpu_torch.synthetic import random_structure_record
from pesto_tpu_torch.utils import tracing
from pesto_tpu_torch.utils.profiling import device_trace

STAGES = {"record_encode": "predict_batch.record_encode", "batch_encode": "predict_batch.batch_encode",
          "device_wait": "predict_batch.collect"}


@pytest.fixture(scope="module")
def pred():
    base = get_config("i_v4_1")
    cfg = base.replace(layers=(base.layers[0],))
    return Predictor(cfg, init_state_dict(cfg, seed=0), device="cpu")


@pytest.fixture(scope="module")
def recs():
    return [random_structure_record(n_atoms=40 + 60 * i, n_res=8 + 4 * i, seed=i) for i in range(6)]


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.take()
    yield
    tracing.take()


def test_nothing_is_recorded_with_the_profiler_off_and_outside_record(pred, recs):
    before = dict(pred.stage_ms)
    pred.predict_batch(recs)
    with tracing.span("outside") as sp:
        assert sp is None
    got = tracing.take()
    assert got.spans == [] and got.launches == [] and got.dropped == 0
    # the stage totals accumulate all the same
    assert pred.stage_ms["batch_calls"] == before["batch_calls"] + 1
    assert all(pred.stage_ms[k] > before[k] for k in STAGES)


def test_predict_batch_spans_nest_across_the_record_encode_threads(pred, recs):
    """All of the record work on the caller's thread: one `.record_encode`
    span for the sizes of every record ahead of the plan, then one per
    chunk ahead of its `.batch_encode`, over the records it codes (each
    under an `.encode_record` span, each structure once), with the chunks
    in flight when it opened."""
    with tracing.record():
        out = pred.predict_batch(recs, atoms_per_call=1024)
    assert all(o is not None for o in out)
    spans = tracing.take().spans
    (call,) = [s for s in spans if s.name == "predict_batch"]
    assert call.parent_id == 0 and call.attrs == {"structures": len(recs)}
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s is not call:
            assert s.attrs.get("call", call.span_id) == call.span_id
            assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    (plan,) = [s for s in spans if s.name == "predict_batch.plan"]
    sizing, *encs = sorted((s for s in spans if s.name == "predict_batch.record_encode"), key=lambda s: s.start_ns)
    assert sizing.attrs["records"] == len(recs) and sizing.attrs["in_flight"] == 0
    assert sizing.end_ns <= plan.start_ns
    chunks = sorted((s for s in spans if s.name == "predict_batch.batch_encode"), key=lambda s: s.start_ns)
    assert len(chunks) >= 2 and all(by_id[s.parent_id] is call for s in chunks)
    assert len(encs) == len(chunks) and sum(s.attrs["records"] for s in encs) == len(recs)
    # the default pipeline_depth, 2: the chunks submitted and not yet collected
    assert [s.attrs["in_flight"] for s in encs] == [min(k, 2) for k in range(len(encs))]
    for k, (enc, chunk) in enumerate(zip(encs, chunks)):
        assert by_id[enc.parent_id] is call and enc.thread == call.thread
        assert plan.end_ns <= enc.start_ns <= enc.end_ns <= chunk.start_ns
        if k:
            assert chunks[k - 1].end_ns <= enc.start_ns
    records = [s for s in spans if s.name == "predict_batch.encode_record"]
    assert sorted(s.attrs["structure"] for s in records) == list(range(len(recs)))
    for s in records:  # on the caller's thread, inside its chunk's stage
        enc = by_id[s.parent_id]
        assert enc in encs and s.thread == call.thread
        assert enc.start_ns <= s.start_ns <= s.end_ns <= enc.end_ns
    assert [len([s for s in records if s.parent_id == e.span_id]) for e in encs] == [e.attrs["records"] for e in encs]
    assert sum(s.attrs["B"] for s in chunks) == len(recs)
    assert sum(s.attrs["real_atoms"] for s in chunks) == sum(len(r["xyz"]) for r in recs)
    assert all(s.attrs["padded_atoms"] == s.attrs["B"] * s.attrs["na"] for s in chunks)
    assert all(s.attrs["h2d_bytes"] == 0 for s in chunks)  # no card: nothing copied
    launches = [s for s in spans if s.name == "predict_batch.launch"]
    assert len(launches) == len(chunks) == len([s for s in spans if s.name == "predict_batch.collect"])
    assert all(s.attrs["knn_launches"] == s.attrs["edge_launches"] == 0 for s in launches)  # plain versions


def test_stage_ms_sums_the_matching_spans_while_recording(pred, recs):
    before = dict(pred.stage_ms)
    with tracing.record():
        pred.predict_batch(recs, atoms_per_call=1024)
        pred.predict_batch(recs[:3])
    spans = tracing.take().spans
    for key, name in STAGES.items():
        want = sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6
        assert pred.stage_ms[key] - before[key] == pytest.approx(want, rel=1e-9, abs=1e-9)
    assert pred.stage_ms["batch_calls"] == before["batch_calls"] + 2


def test_take_clears_the_buffer_and_the_cap_counts_drops():
    rec = tracing.Recorder(cap=3)
    with rec.record():
        for i in range(5):
            with rec.span("s", i=i):
                pass
        for _ in range(4):
            rec.launch("k")
    got = rec.take()
    assert [s.attrs["i"] for s in got.spans] == [0, 1, 2]
    assert len(got.launches) == 3 and got.dropped == 2 + 1
    assert rec.take() == tracing.Recording([], [], 0)
    with rec.span("after") as sp:  # outside record(): off again
        assert sp is None
    assert rec.take().spans == []


def test_a_span_records_under_the_profiler_and_contains_its_ops():
    """The clock: a span around a CPU op contains the op's interval as the
    profiler (Kineto) stamps it, in unix ns."""
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("around_mm") as sp:
            assert sp is not None
            a @ b
    (s,) = tracing.take().spans
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def test_the_launch_stamp_fires_only_while_recording():
    called = []

    def c_call(ptr, stream):
        called.append(time.time_ns())
        return 0

    entry = _build.Entry("knn", "fake_launch", "p")
    entry._fn, entry._device, entry._stream = c_call, (lambda: -1), (lambda dev: 0)
    x = torch.zeros(4)
    entry(x)
    assert tracing.take().launches == []
    with tracing.record():
        entry(x)
    (stamp,) = tracing.take().launches
    assert stamp.name == "fake_launch" and stamp.ns <= called[-1] and len(called) == 2


def test_device_trace_writes_the_predict_batch_span_around_the_calls_ops(pred, recs, tmp_path):
    with device_trace(str(tmp_path)):
        pred.predict_batch(recs[:3])
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (call,) = [e for e in events if e.get("cat") == "program_span" and e["name"] == "predict_batch"]
    assert {e["name"] for e in events if e.get("cat") == "program_span"} >= set(STAGES.values())
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == call["tid"]]
    assert ops and any(e["name"] == "aten::mm" or e["name"] == "aten::addmm" for e in ops)
    eps = 0.01  # us: the trace's float rounding
    for e in ops:
        assert call["ts"] - eps <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"] + eps, e["name"]
