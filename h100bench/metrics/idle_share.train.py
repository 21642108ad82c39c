"""% of the traced train steps in which no device op ran."""
from h100bench import harness


def read(run):
    return harness.idle_share(run)
