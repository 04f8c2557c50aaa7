"""Plain PyTorch versions of one threshold + min-label hook step: over the
whole (p, p) S, and over a row slab of it (the sharded screen's step)."""

from __future__ import annotations

import torch

#: label given to "no neighbour" in the masked min-reduce (above any vertex)
BIG = 2**30


def labelprop_step_ref(S: torch.Tensor, labels: torch.Tensor, lam: float) -> torch.Tensor:
    """new_l_i = min(l_i, min over j != i with |S_ij| > lam of l_j), int32.

    The comparison runs in S's own dtype (a float64 S is never cast), and
    ties |S_ij| == lam are not edges (strict eq. (4))."""
    p = S.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=S.device)
    mask = (S.abs() > lam) & ~eye
    labels = labels.to(torch.int32)
    big = torch.tensor(BIG, dtype=torch.int32, device=S.device)
    neigh = torch.where(mask, labels[None, :], big)
    return torch.minimum(labels, neigh.amin(dim=1))


def labelprop_rows_ref(
    S_rows: torch.Tensor, labels: torch.Tensor, lam: float, row0: int
) -> torch.Tensor:
    """The hook step of S's rows [row0, row0 + rows), given as the (rows,
    pp) slab ``S_rows``, against the full (pp,) ``labels``: the slab's new
    int32 labels.  The diagonal is masked by global row (the reference's
    ``distributed_components``: ``ii = row0 + arange(rows)``)."""
    rows, pp = S_rows.shape
    ii = row0 + torch.arange(rows, device=S_rows.device)
    jj = torch.arange(pp, device=S_rows.device)
    mask = (S_rows.abs() > lam) & (ii[:, None] != jj[None, :])
    labels = labels.to(torch.int32)
    big = torch.tensor(BIG, dtype=torch.int32, device=S_rows.device)
    neigh = torch.where(mask, labels[None, :], big)
    return torch.minimum(labels[row0 : row0 + rows], neigh.amin(dim=1))
