"""% of the traced predict_batch call in which no device op ran."""
from h100bench import harness


def read(run):
    return harness.idle_share(run)
