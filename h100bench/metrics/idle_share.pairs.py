"""% of the traced predict_pairs call in which no device op ran: the scan
cells' reader (`idle_share.scan`), which reads the traced call's window."""
from h100bench import harness

read = harness.load_module("metrics", "idle_share.scan").read
