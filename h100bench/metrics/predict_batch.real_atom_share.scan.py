"""% of the atom rows the traced predict_batch call sent to the card that
hold real atoms: the chunks' real atoms over B x na (the bucket's padded
rows, the sink row included), from the predict_batch.batch_encode spans."""
from h100bench import harness


def read(run):
    spans = harness.load_module("metrics", "_program_spans")
    real, padded = spans.chunk_sum(run, "real_atoms"), spans.chunk_sum(run, "padded_atoms")
    return None if not padded else 100.0 * real / padded
