"""Operations and bytes of one state-update layer's edge attention, the
work of the forward edge kernel, from the layer equations.

Counted per real atom and neighbour edge (a multiply-add is 2 operations;
exponentials and ELUs are not counted): the edge features (|p_m|, <p_n, r>,
<p_m, r>), the three edge MLPs (the first layer on the edge's 4S + 1
inputs; the atom's own 2S inputs are the per-atom term, counted once per
atom), the attention logits and the value sums. Bytes: each input read
once (the state table, ids, distances, directions, queries, weights) and
each output written once, at the data type's width (ids 4 bytes).
"""


def per_edge_macs(S=32, Nh=2, Nk=3):
    features = 3 * 3 * S
    mlp1 = (4 * S + 1) * 4 * S
    mlp2 = S * S + S * S + 2 * S * 2 * S
    mlp3 = S * Nk + S * 3 * Nk + 2 * S * 2 * S
    logits = Nh * Nk + 3 * Nh * Nk
    values = Nh * S + 3 * S + Nh + 3 * Nh * S + 3 * Nh * S
    return features + mlp1 + mlp2 + mlp3 + logits + values


def per_atom_macs(S=32, Nh=2, Nk=3):
    """The per-atom term of the first edge layer, and the mean vector's share."""
    return 2 * S * 4 * S + 3 * Nh * S


def weight_count(S=32, Nh=2, Nk=3):
    return ((6 * S + 1) * 4 * S + 4 * S + (S * S + S * S + 4 * S * S) + 4 * S
            + (S * Nk + S * 3 * Nk + 4 * S * S) + (4 * Nk + 2 * S))


def input_bytes(n, nn, S=32, Nh=2, Nk=3, dt_bytes=4):
    """The state table, distances, directions, queries and weights, and the ids."""
    return (n * (4 * S + nn + 3 * nn + 2 * Nh * Nk) + weight_count(S, Nh, Nk)) * dt_bytes + n * nn * 4


def output_bytes(n, S=32, Nh=2, dt_bytes=4):
    return n * (Nh * S + 3 * Nh * S) * dt_bytes


def cost(n: int, nn: int, S=32, Nh=2, Nk=3, dt_bytes=4):
    """(operations, bytes) of one layer over n real atoms with nn neighbours."""
    flops = 2 * (n * nn * per_edge_macs(S, Nh, Nk) + n * per_atom_macs(S, Nh, Nk))
    return flops, input_bytes(n, nn, S, Nh, Nk, dt_bytes) + output_bytes(n, S, Nh, dt_bytes)
