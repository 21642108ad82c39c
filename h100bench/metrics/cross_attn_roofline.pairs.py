"""The cross-attention kernel's share of its roofline in the traced
predict_pairs call: the least time for the layer equations' work over the
call's real pairs (`costs/cross_attn.py`: both directions, every layer),
against the device time of the kernel named below (found by name). Float32
work is held at the TF32 peak, as `harness.roofline` holds the edge
kernel: an fp32-FMA kernel can reach at most 67/495 = 13.5% of it."""
from h100bench import harness

KERNELS = ("cross_attention_kernel",)


def read(run):
    pairs = run.work.get("slice_pairs")
    if run.trace is None or not pairs:
        return None
    seconds = run.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    cost = harness.load_module("costs", "cross_attn").cost
    cfg, pk = run.config, harness.peaks()
    layers = len(cfg["nn"])
    flops = nbytes = 0.0
    for n_a, n_b in pairs:
        f, b = cost(int(n_a), int(n_b), cfg["Ns"], cfg["cross"]["cNh"], cfg["cross"]["cNk"])
        flops, nbytes = flops + layers * f, nbytes + layers * b
    bound = max(flops / pk["tf32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
