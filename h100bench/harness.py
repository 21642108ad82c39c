"""The benchmark's core: the spec, the registries by name, a run's record,
the traced slice and the result line.

Everything that belongs to one configuration, traffic mix, entry point or
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json or the mix gives it:

  configs/<config>.json    sizes of a model configuration
  traffic/<mix>.json       parameters of a traffic mix; its "driver" names
  drivers/<driver>.py      the timed loop of one entry point: run(cell, ctx)
  metrics/<metric>.py      the reader of one per-layer metric: read(run)
  limits/<workload>.json   the limits of the numbers `correct` compares
  costs/<kernel>.py        operations and bytes of one kernel or step
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pesto_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_spec(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """h100bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"h100bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of `workloads` with everything it names."""

    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(spec: dict, name: str, root=ROOT) -> Cell:
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, config=load_json(os.path.relpath(os.path.join(root, conf["file"]), HERE)),
                mix=load_json("traffic", f"{w['traffic']}.json"),
                chips=int(w["chips"]), limits=load_json("limits", f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


@dataclass
class Trace:
    """The device timeline of a traced slice, in seconds from its first
    op: kernels and copies [(name, start, dur)]."""

    window_s: float
    ops: list

    def busy_s(self) -> float:
        """Seconds in which some device op ran (their union)."""
        busy, end = 0.0, -math.inf
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, 0.0), min(s + d, self.window_s)
            if e <= s:
                continue
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def gaps(self):
        """Idle stretches [(start, end)] of the device within the slice."""
        out, end = [], 0.0
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                out.append((end, min(s, self.window_s)))
            end = max(end, s + d)
        if end < self.window_s:
            out.append((end, self.window_s))
        return [(a, b) for a, b in out if b > a]

    def kernel_s(self, names) -> float:
        return sum(d for n, _, d in self.ops if any(k in n for k in names))

    def breakdown(self) -> dict:
        """The ten device ops that took most time, and the ten longest idle
        gaps, each named by the op the device waited for (the host was
        preparing or launching it)."""
        by = {}
        for n, _, d in self.ops:
            by[short_name(n)] = by.get(short_name(n), 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        starts = sorted((s, n) for n, s, _ in self.ops)
        gaps = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]:
            nxt = next((n for s, n in starts if s >= b - 1e-9), None)
            gaps.append([f"before {short_name(nxt)}" if nxt else "before the first or after the last op", b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def note(t0: float, what: str) -> None:
    """A line on standard error: seconds since process start at a step."""
    print(f"h100bench: {time.time() - t0:8.2f} s {what}", file=sys.stderr, flush=True)


def peaks() -> dict:
    return load_json("peaks.json")


def idle_share(run) -> float:
    """% of the traced slice in which no device op ran; None untraced or
    where the trace holds no device op."""
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def roofline(run, cost_name: str, sizes, seconds: float) -> float:
    """% of the least time the card could take for the layers' work over
    structures of `sizes` real atoms (each through every layer of the
    config, at its nn), against the `seconds` the kernels took; None
    where nothing was measured."""
    if not sizes or not seconds or seconds <= 0:
        return None
    cost = load_module("costs", cost_name).cost
    cfg, pk = run.config, peaks()
    flops = nbytes = 0.0
    for n in sizes:
        for nn in cfg["nn"]:
            f, b = cost(int(n), nn, cfg["Ns"], cfg["Nh"], cfg["Nk"])
            flops, nbytes = flops + f, nbytes + b
    bound = max(flops / pk["tf32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def short_name(kernel: str) -> str:
    """A CUDA kernel's name without its namespace, arguments and template."""
    name = kernel.replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i >= 0]
    name = name[: min(cut)] if cut else name
    return (name.split() or [name])[-1].split("::")[-1][:60]


def profile(fn):
    """Run fn() under torch.profiler with the device's activity alone (the
    host's op recording would slow a host-paced step and inflate its idle
    time), the device synchronised before and after. Returns (fn's result,
    a callable that makes the slice's Trace, the slice's wall seconds with
    the profiler's start and stop): make the Trace after the window."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    t_outer = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()  # no earlier work in the slice
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, (lambda: trace_of(prof, wall)), time.perf_counter() - t_outer


def trace_of(prof, wall_s: float) -> Trace:
    """The slice's device ops, placed from its first op; the window is the
    slice's wall time by the host clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # a record_function range shown on the device timeline is not device work
    dev = [e for e in prof.events() if e.device_type == cuda and not e.name.startswith("Activity Buffer")
           and not getattr(e, "is_user_annotation", False)]
    t0 = min((e.time_range.start for e in dev), default=0)
    ops = [(e.name, (e.time_range.start - t0) / 1e6, e.time_range.elapsed_us() / 1e6) for e in dev]
    return Trace(window_s=max(wall_s, max((s + d for _, s, d in ops), default=0.0)), ops=ops)


@dataclass
class Run:
    """What a driver hands back: the counts, the end-to-end values by
    name, the numbers `correct` compares with their limits, and what the
    per-layer readers read."""

    attempted: int = 0
    failed: int = 0
    values: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)    # [(name, value, limit)]
    memory_peak_bytes: int = 0
    window_s: float = 0.0
    trace: Trace = None
    spans: dict = field(default_factory=dict)     # name -> [seconds]
    counters: dict = field(default_factory=dict)  # name -> number
    work: dict = field(default_factory=dict)      # what the window and the slice computed
    config: dict = None
    extra: dict = field(default_factory=dict)

    def check(self, name, value, limit):
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def sample(seed: int, candidates, sizes, k: int) -> list:
    """k of the candidates drawn from the seed, the largest always among them."""
    import numpy as np

    cand = np.asarray(sorted(candidates))
    if len(cand) == 0:
        return []
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = set(rng.choice(cand, size=min(k, len(cand)), replace=False).tolist())
    pick.add(int(cand[np.argmax([sizes[i] for i in cand])]))
    return sorted(pick)


def process_start() -> float:
    """This process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def result_line(cell: Cell, run: Run, trace: bool, device: dict) -> dict:
    """The contract's last line: end-to-end metrics untraced, per-layer
    metrics traced; `checks` last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if run.trace is not None:
            device = dict(device, busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(run.values[m["name"]]), "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line.update(run.extra)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return line
