"""The train step's backward, ms by CUDA events through the step's `mark`
hook, the median over the window's steps."""
import statistics


def read(run):
    ms = run.spans.get("train_step.backward_ms")
    return statistics.median(ms) if ms else None
