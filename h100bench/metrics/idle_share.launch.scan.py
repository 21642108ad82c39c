"""% of the traced predict_batch call in which the card was idle while the host
was in the launch (predict_batch.launch: the kNN, the forward's ops and the
sigmoid enqueued, the copy back to the host). The five
idle_share.<stage>.scan shares add up to idle_share.scan (_program_spans.py
says how)."""
from h100bench import harness


def read(run):
    return harness.load_module("metrics", "_program_spans").idle_share(run, "launch")
