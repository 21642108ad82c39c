import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the trainer's modules import tensorboard's writer lazily; keep TensorFlow out
sys.modules.setdefault("torch.utils.tensorboard", None)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA H100 (CUDA); skips on a machine without one")
