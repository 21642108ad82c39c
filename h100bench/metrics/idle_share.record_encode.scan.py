"""% of the traced predict_batch call in which the card was idle while the host
was in the record encode (predict_batch.record_encode: the thread pool over
the records, before the first chunk). The five idle_share.<stage>.scan
shares add up to idle_share.scan (_program_spans.py says how)."""
from h100bench import harness


def read(run):
    return harness.load_module("metrics", "_program_spans").idle_share(run, "record_encode")
