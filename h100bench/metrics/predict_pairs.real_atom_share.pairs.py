"""% of the atom rows the traced predict_pairs call sent to the card that
hold real atoms: the chunks' real atoms of both sides over B x (na_a +
na_b) (the buckets' padded rows, the sink rows included), from the
predict_pairs.batch_encode spans."""
from h100bench import harness


def read(run):
    chunks = harness.load_module("metrics", "_pair_spans").chunks(run)
    if not chunks:
        return None
    padded = sum(c["padded_atoms"] for c in chunks)
    return 100.0 * sum(c["real_atoms"] for c in chunks) / padded if padded else None
