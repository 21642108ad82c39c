"""The forward edge kernel's share of its roofline in the traced
predict_pairs call: the scan cells' reader (`edge_fwd_roofline.scan`),
which counts the layer equations' work over the run's `slice_atoms`. The
pair driver puts there both chains' real atoms of every pair the traced
call answered."""
from h100bench import harness

read = harness.load_module("metrics", "edge_fwd_roofline.scan").read
