"""Plain exact k nearest neighbours of a structure's atoms."""

import torch


def knn(X: torch.Tensor, k: int = 64, dtype=torch.float64, block: int = 1024) -> torch.Tensor:
    """ids [n, k] int64 of each atom's k nearest other atoms, nearest first,
    from direct coordinate differences in `dtype`. An atom within 1e-2 A of
    another counts as a duplicate and, like the atom itself, is never a
    neighbour (the published encoding's rule for duplicate positions)."""
    X = X.to(dtype)
    n = X.shape[0]
    if n <= k:
        raise ValueError(f"{n} atoms: every atom needs {k} neighbours")
    out = torch.empty((n, k), dtype=torch.int64, device=X.device)
    cols = torch.arange(n, device=X.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        diff = X[r0:r1, None, :] - X[None, :, :]
        dsq = (diff * diff).sum(-1)
        dsq = torch.where((cols[r0:r1, None] == cols[None, :]) | (dsq < 1e-4),
                          torch.full_like(dsq, float("inf")), dsq)
        val, idx = torch.topk(dsq, k, dim=1, largest=False, sorted=True)
        # rows where the k-th distance ties with one left out: a stable sort
        # of the whole row, whose columns are in index order, keeps the
        # lower indices
        tied = (dsq <= val[:, -1:]).sum(1) > k
        if tied.any():
            rows = torch.nonzero(tied).squeeze(1)
            idx[rows] = torch.sort(dsq[rows], dim=1, stable=True).indices[:, :k]
            val[rows] = dsq[rows].gather(1, idx[rows])
        # among equal distances the lower index first
        order = torch.argsort(idx, dim=1)
        val, idx = val.gather(1, order), idx.gather(1, order)
        order = torch.argsort(val, dim=1, stable=True)
        out[r0:r1] = idx.gather(1, order)
    return out
