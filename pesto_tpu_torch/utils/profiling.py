"""Tracing and stage profiling (port of `pesto_tpu/utils/profiling.py`).

The reference's observability is wall-clock stage timing (profiling.py:68-119)
plus the Logger ETA helper. Here:

  - StageTimer: named stage accumulator with throughput summary;
  - device_trace: context manager around a `torch.profiler` trace of the
    host and, where there is one, the GPU, written to a directory as a
    Chrome trace (view it in Perfetto or chrome://tracing) with the
    program's spans (`tracing`) beside the profiler's events;
  - chained_timing: the time of one iteration of a function whose first
    argument is chained through the iterations: CUDA events on a CUDA
    tensor, the host clock on the CPU.
"""

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch

from . import tracing


class StageTimer:
    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, ts in self.times.items():
            arr = np.array(ts)
            out[name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "median_ms": float(np.median(arr) * 1e3),
            }
        return out

    def report(self) -> str:
        return "\n".join(
            f"{name:>12}: n={s['count']:>5}  mean={s['mean_ms']:8.2f} ms  "
            f"median={s['median_ms']:8.2f} ms  total={s['total_s']:8.2f} s"
            for name, s in self.summary().items()
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block, written to
    `log_dir/trace.json` (Chrome trace format). Records the GPU's kernels
    too where CUDA is available, and the spans the program recorded in the
    block (category `program_span`, on their own threads, in the trace's
    time base). Yields the profiler, whose `key_averages()` gives the sums
    by operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in tracing.take().spans if s.start_ns >= start])


def _add_spans(path: str, spans) -> None:
    """Write `tracing` spans into the Chrome trace at `path`: complete
    events whose microseconds count from the trace's
    `baseTimeNanoseconds`, as the profiler's own events do."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": dict(s.attrs, span_id=s.span_id, parent_id=s.parent_id)}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def chained_timing(fn: Callable, chain_arg, *rest, iters: int = 10) -> float:
    """Seconds per call of `fn(chain_arg, *rest) -> (new_chain_arg, out)`,
    chaining the first argument through `iters` calls after one warm call.

    When `out` holds a CUDA tensor, the time is that of CUDA events on the
    current stream around the calls (the device's time for the work they
    queue, with a synchronise at the end); otherwise it is the host clock
    around the calls, which on the CPU is the work's own time."""
    x, out = fn(chain_arg, *rest)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x, out = fn(x, *rest)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x, out = fn(x, *rest)
    return (time.perf_counter() - t0) / iters
