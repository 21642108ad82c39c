"""The forward edge kernel's share of its roofline in the traced
predict_batch call: the least time for the layer equations' work over the
call's real atoms, every layer at its nn, against the device time of the
kernels named below. The forward edge launch has no profiler range, so
its kernels are found by name."""
from h100bench import harness

KERNELS = ("edge_attention_kernel", "atom_term_kernel")


def read(run):
    if run.trace is None:
        return None
    return harness.roofline(run, "edge_fwd", run.work.get("slice_atoms"), run.trace.kernel_s(KERNELS))
