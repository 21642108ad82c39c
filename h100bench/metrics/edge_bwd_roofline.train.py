"""The backward edge kernel's share of its roofline in the traced train
steps: the least time for the layer's VJP (twice the forward's products)
over the steps' real atoms, every layer at its nn, against the device time
of the backward launch's kernels, found by their names (csrc/
edge_attention_bwd.cu: pre-pass, weight pack, tile, per-atom gradient,
partial sums, cast)."""
from h100bench import harness

KERNELS = ("edge_bwd_",)


def read(run):
    if run.trace is None:
        return None
    sizes = [n for n, _ in run.work.get("slice_structures", [])]
    return harness.roofline(run, "edge_bwd", sizes, run.trace.kernel_s(KERNELS))
