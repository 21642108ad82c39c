"""Operations and bytes of one layer's edge-attention backward (the VJP),
the work of the backward edge kernel.

Operations: twice the forward's (`edge_fwd`): the products against the
output gradients and against the inputs. A forward rebuilt inside the
backward is the implementation's choice and is not counted. Bytes: the
forward's inputs and both output gradients read once, the gradients of
those inputs (the ids excepted) written once.
"""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "h100bench_costs_edge_fwd", os.path.join(os.path.dirname(os.path.abspath(__file__)), "edge_fwd.py"))
edge_fwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(edge_fwd)


def cost(n: int, nn: int, S=32, Nh=2, Nk=3, dt_bytes=4):
    flops, _ = edge_fwd.cost(n, nn, S, Nh, Nk, dt_bytes)
    inputs = edge_fwd.input_bytes(n, nn, S, Nh, Nk, dt_bytes)
    grads_in = edge_fwd.output_bytes(n, S, Nh, dt_bytes)
    grads_out = inputs - n * nn * 4
    return 2 * flops, inputs + grads_in + grads_out
