"""% of the traced slice of the serving window in which no device op ran."""
from h100bench import harness


def read(run):
    return harness.idle_share(run)
