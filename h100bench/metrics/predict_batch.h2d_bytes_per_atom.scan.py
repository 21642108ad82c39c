"""Bytes the traced predict_batch call copied to the card per real atom:
the chunks' batch buffers (coordinates, features or codes, membership or
residue codes, mask) over their real atoms, from the
predict_batch.batch_encode spans."""
from h100bench import harness


def read(run):
    spans = harness.load_module("metrics", "_program_spans")
    sent, real = spans.chunk_sum(run, "h2d_bytes"), spans.chunk_sum(run, "real_atoms")
    return None if not real else sent / real
