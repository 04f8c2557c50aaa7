"""Plain PyTorch version of one threshold + min-label hook step."""

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
