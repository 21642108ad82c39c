"""The benchmark's plain reference: float32 PyTorch and NumPy, imports
nothing of the program."""
