"""The dimer's whole forward's share of the card's float32 peak over the
window: the layer equations' operations of every pair answered (real
atoms only, `costs/cross_forward.py`) over the window's time and the TF32
peak."""
from h100bench import harness


def read(run):
    # a traced run leaves its profiled slice out: the profiler slows it
    flops = run.work["forward_flops"] - run.work.get("excluded_flops", 0.0)
    seconds = run.window_s - run.work.get("excluded_s", 0.0)
    return 100.0 * flops / (seconds * harness.peaks()["tf32_flops_per_s"]) if seconds > 0 else None
