"""The train step's optimizer update, ms by CUDA events through the step's `mark`
hook, the median over the window's steps."""
import statistics


def read(run):
    ms = run.spans.get("train_step.optimizer_ms")
    return statistics.median(ms) if ms else None
