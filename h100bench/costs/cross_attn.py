"""Operations and bytes of one cross-state layer's cross attention between
two structures of n_a and n_b real atoms, both directions: the work of
the cross-attention kernel, from the layer equations.

Operations: for each (query atom, head, partner atom) the logit (cNk
multiply-adds) and the value sum (S multiply-adds), in both directions:
4 n_a n_b cNh (cNk + S), a multiply-add counted as 2; the exponentials and
the softmax's sums are not counted. Bytes: both structures' queries
[n, cNh, cNk], keys [n, cNk] and values [n, S] read once and the heads'
sums [n, cNh S] written once, at the data type's width.
"""


def cost(n_a: int, n_b: int, S=32, cNh=2, cNk=3, dt_bytes=4):
    """(operations, bytes) of one layer's cross attention of a pair."""
    flops = 4 * n_a * n_b * cNh * (cNk + S)
    nbytes = (n_a + n_b) * (cNh * cNk + cNk + S + cNh * S) * dt_bytes
    return flops, nbytes
