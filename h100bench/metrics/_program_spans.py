"""The program's spans of the traced predict_batch call laid over the
device timeline: the part the readers of the `idle_share.<stage>.scan`
and `predict_batch.*.scan` metrics share. Not a metric itself.

The spans and launch stamps are those `pesto_tpu_torch.utils.tracing`
recorded while the profiler ran; a program without that module, a call
with no `predict_batch` span, or a trace with no device op gives None,
and every reader then returns None.

Alignment. `Trace` keeps its ops in seconds from its first op. A device op
never starts before the host call that enqueued it, so each pair of a
launch stamp (unix ns, just before the C call) and the kernel it enqueued
bounds the first op's unix time from below: origin >= stamp - offset. So
does the call's own start: every op of the slice is enqueued inside the
call. The origin is the largest of these bounds, exact up to the launch
latency where the card was idle at the enqueue (the gaps that matter
here). A stamp pairs with an op by order: the k-th stamp of an entry
point with the k-th op of the kernel it launches first (FIRST_KERNEL); an
entry point whose stamps and ops differ in number pairs nothing.

Attribution. The slice is [call start, call start + window]: it holds
every op, since the trace's window runs from before the call to after
the device finished. Each idle instant of it goes to the innermost stage
span (STAGES) open on the calling thread at that instant, and to "other"
under none (bucketing, the call's own code, the slice after the call), so
the shares add up to `idle_share.scan`.
"""

from h100bench import harness

# entry point of csrc/ (tracing.Launch.name) -> the kernel it launches first
FIRST_KERNEL = {"knn_prep": "morton_box_kernel", "knn_top64": "gather_boxes_kernel",
                "edge_attention": "atom_term_kernel"}
STAGES = {"predict_batch.record_encode": "record_encode", "predict_batch.batch_encode": "batch_encode",
          "predict_batch.buffer_wait": "batch_encode", "predict_batch.launch": "launch",
          "predict_batch.collect": "collect"}
SHARES = ("record_encode", "batch_encode", "launch", "collect", "other")


def view(run):
    """The laid-over call of a traced run (see lay_over), taken from the
    program once and kept on the run; None where there is nothing to lay."""
    if not hasattr(run, "_program_spans"):
        run._program_spans = None
        if run.trace is not None and run.trace.ops and run.trace.window_s > 0:
            try:
                from pesto_tpu_torch.utils import tracing
            except ImportError:  # a program that records no spans
                return None
            run._program_spans = lay_over(run.trace, tracing.take())
    return run._program_spans


def lay_over(trace, recording):
    """{"origin_ns", "window_ns", "idle_ns": {share: ns}, "chunks": [the
    batch_encode spans' attributes], "pairs": [(stamp ns, op's start ns)]}
    for the first `predict_batch` call of the recording over the trace;
    None without such a call or device ops."""
    calls = [s for s in recording.spans if s.name == "predict_batch"]
    if not calls or not trace.ops:
        return None
    call = min(calls, key=lambda s: s.start_ns)
    mine = [s for s in recording.spans if call.start_ns <= s.start_ns <= call.end_ns]
    ops = sorted((round(s * 1e9), round((s + d) * 1e9), harness.short_name(n)) for n, s, d in trace.ops)
    pairs = []
    for entry, kernel in FIRST_KERNEL.items():
        stamps = sorted(x.ns for x in recording.launches if x.name == entry)
        starts = [a for a, _, n in ops if n == kernel]
        if stamps and len(stamps) == len(starts):
            pairs += zip(stamps, starts)
    origin = max([call.start_ns] + [stamp - start for stamp, start in pairs])
    window = round(trace.window_s * 1e9)
    lo, hi = call.start_ns, call.start_ns + window
    stages = sorted((s.start_ns, -s.end_ns, STAGES[s.name]) for s in mine
                    if s.name in STAGES and s.thread == call.thread)
    segments = [(lo, hi, "other")]
    for a, neg_b, share in stages:  # parents before their children: the innermost paints last
        segments = _paint(segments, a, -neg_b, share)
    idle = dict.fromkeys(SHARES, 0)
    gaps = _gaps(((origin + a, origin + b) for a, b, _ in ops), lo, hi)
    k = 0
    for a, b in gaps:
        while segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            s, e, share = segments[j]
            idle[share] += min(b, e) - max(a, s)
            j += 1
    return {"origin_ns": origin, "window_ns": window, "idle_ns": idle,
            "chunks": [s.attrs for s in mine
                       if s.name == "predict_batch.batch_encode" and s.attrs.get("call") == call.span_id],
            "pairs": sorted((stamp, origin + start) for stamp, start in pairs)}


def _paint(segments, a, b, share):
    """The segments [(start, end, share)] with [a, b) painted `share`."""
    out = []
    for s, e, old in segments:
        if e <= a or s >= b:
            out.append((s, e, old))
            continue
        if s < a:
            out.append((s, a, old))
        out.append((max(s, a), min(e, b), share))
        if e > b:
            out.append((b, e, old))
    return out


def _gaps(intervals, lo, hi):
    """The stretches of [lo, hi) that none of the intervals covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def idle_share(run, share):
    """% of the traced slice idle under the stage `share`; None unlaid."""
    v = view(run)
    return None if v is None else 100.0 * v["idle_ns"][share] / v["window_ns"]


def chunk_sum(run, key):
    """The sum of one attribute over the call's chunks; None unlaid."""
    v = view(run)
    return None if v is None or not v["chunks"] else float(sum(c[key] for c in v["chunks"]))
