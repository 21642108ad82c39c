"""% of the traced predict_batch call in which the card was idle while the host
was in the batch encode (predict_batch.batch_encode: the bucket's buffers
filled and copied to the card, the wait for a free pinned set included). The
five idle_share.<stage>.scan shares add up to idle_share.scan
(_program_spans.py says how)."""
from h100bench import harness


def read(run):
    return harness.load_module("metrics", "_program_spans").idle_share(run, "batch_encode")
