"""CPU tests of the readers that lay the program's spans over the device
timeline (metrics/_program_spans.py and its seven metrics), on synthetic
traces whose unix times are known."""

import sys

import pytest

from h100bench import harness
from pesto_tpu_torch.utils import tracing

READERS = ("idle_share.record_encode.scan", "idle_share.batch_encode.scan", "idle_share.launch.scan",
           "idle_share.collect.scan", "idle_share.other.scan", "predict_batch.real_atom_share.scan",
           "predict_batch.h2d_bytes_per_atom.scan")
SHARES = READERS[:5]
T0 = 1_790_000_000_000_000_000  # the call's start, unix ns
US = 1_000
THREAD = 7


def span(name, a_us, b_us, sid, parent, thread=THREAD, **attrs):
    return tracing.Span(name, T0 + a_us * US, T0 + b_us * US, sid, parent, thread, attrs)


def recording():
    """One call of one chunk: record encode 100-3000 us (a worker's record
    span inside it), bucketing to 3100, the batch encode to 3500 with a
    buffer wait at 3150-3250, the launch to 5000, the readback to 9000."""
    spans = [span("predict_batch", 0, 10_000, 1, 0, structures=2),
             span("predict_batch.record_encode", 100, 3_000, 2, 1, call=1),
             span("predict_batch.encode_record", 200, 2_900, 3, 2, thread=8, call=1, structure=0),
             span("predict_batch.plan", 3_000, 3_100, 4, 1, call=1),
             span("predict_batch.buffer_wait", 3_150, 3_250, 6, 5),
             span("predict_batch.batch_encode", 3_100, 3_500, 5, 1, call=1, na=1024, nr=128, B=2,
                  padded_atoms=2048, real_atoms=1536, h2d_bytes=36_864),
             span("predict_batch.launch", 3_500, 5_000, 7, 1, call=1, knn_launches=1, edge_launches=2),
             span("predict_batch.collect", 5_000, 9_000, 8, 1, call=1)]
    launches = [tracing.Launch("knn_prep", T0 + 3_600 * US, THREAD),
                tracing.Launch("edge_attention", T0 + 3_800 * US, THREAD),
                tracing.Launch("edge_attention", T0 + 4_000 * US, THREAD)]
    return tracing.Recording(spans, launches, 0)


# device ops in unix us from T0: the copy, the kNN's first kernel at its
# stamp (the card idle), the edge launches' pre-pass 5 us and 300 us after
# their stamps (the second queued), the readback's copy
DEVICE = [("Memcpy HtoD (Pinned -> Device)", 3_300, 3_400),
          ("void (anonymous namespace)::morton_box_kernel(float4 const*, int, float*)", 3_600, 3_700),
          ("void (anonymous namespace)::atom_term_kernel<float>(Args<float>, float*)", 3_805, 3_900),
          ("void (anonymous namespace)::edge_attention_kernel<float>(Args<float>)", 3_900, 4_300),
          ("void (anonymous namespace)::atom_term_kernel<float>(Args<float>, float*)", 4_300, 4_400),
          ("void (anonymous namespace)::edge_attention_kernel<float>(Args<float>)", 4_400, 6_000),
          ("Memcpy DtoH (Device -> Pinned)", 6_000, 6_100)]
FIRST = 3_300
WINDOW_US = 10_500


def traced_run(monkeypatch, rec=None, ops=True):
    trace = harness.Trace(window_s=WINDOW_US / 1e6,
                          ops=[(n, (a - FIRST) / 1e6, (b - a) / 1e6) for n, a, b in DEVICE] if ops else [])
    monkeypatch.setattr(tracing, "take", lambda: rec if rec is not None else recording())
    return harness.Run(trace=trace, config={})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_the_origin_is_recovered_from_the_launch_stamps():
    trace = harness.Trace(window_s=WINDOW_US / 1e6,
                          ops=[(n, (a - FIRST) / 1e6, (b - a) / 1e6) for n, a, b in DEVICE])
    v = harness.load_module("metrics", "_program_spans").lay_over(trace, recording())
    assert abs(v["origin_ns"] - (T0 + FIRST * US)) <= 1 * US
    # no paired op starts before its stamp; the first chunk's kernel at it
    assert all(start >= stamp for stamp, start in v["pairs"]) and len(v["pairs"]) == 3
    assert v["pairs"][0][1] - v["pairs"][0][0] <= 1 * US


def test_an_entry_whose_stamps_and_kernels_differ_in_number_pairs_nothing():
    rec = recording()
    rec = rec._replace(launches=rec.launches + [tracing.Launch("knn_prep", T0 + 4_500 * US, THREAD)])
    trace = harness.Trace(window_s=WINDOW_US / 1e6,
                          ops=[(n, (a - FIRST) / 1e6, (b - a) / 1e6) for n, a, b in DEVICE])
    v = harness.load_module("metrics", "_program_spans").lay_over(trace, rec)
    # the two pre-pass kernels alone: the first started 5 us after its stamp
    assert len(v["pairs"]) == 2 and abs(v["origin_ns"] - (T0 + (FIRST - 5) * US)) <= 1


def test_the_five_idle_shares_partition_idle_share(monkeypatch):
    run = traced_run(monkeypatch)
    got = {n: read(n, run) for n in SHARES}
    pct = 100.0 / WINDOW_US
    # record encode 100-3000; before it and bucketing to 3100 are "other",
    # and so are the call's end (9000-10000) and the slice after it
    # (10000-10500); the batch encode's idle 3100-3300 and 3400-3500 (the
    # buffer wait inside it); the launch's 3500-3600 and 3700-3805; the
    # readback's after the last op (6100-9000)
    want = {"idle_share.record_encode.scan": 2_900 * pct, "idle_share.batch_encode.scan": 300 * pct,
            "idle_share.launch.scan": 205 * pct, "idle_share.collect.scan": 2_900 * pct,
            "idle_share.other.scan": (100 + 100 + 1_000 + 500) * pct}
    assert got == pytest.approx(want, abs=1e-9)
    assert sum(got.values()) == pytest.approx(harness.idle_share(run), abs=1e-9)


def test_the_chunk_readers_sum_the_batch_encode_spans(monkeypatch):
    run = traced_run(monkeypatch)
    assert read("predict_batch.real_atom_share.scan", run) == pytest.approx(75.0)
    assert read("predict_batch.h2d_bytes_per_atom.scan", run) == pytest.approx(24.0)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_returns_none_without_device_ops_or_spans(name, monkeypatch):
    assert read(name, traced_run(monkeypatch, ops=False)) is None
    assert read(name, harness.Run(config={})) is None  # untraced
    assert read(name, traced_run(monkeypatch, rec=tracing.Recording([], [], 0))) is None
    # a program without spans (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "pesto_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["pesto_tpu_torch.utils"], "tracing")
    assert read(name, traced_run(monkeypatch)) is None
