"""The benchmark of pesto_tpu_torch on the NVIDIA H100 (see run.py)."""
