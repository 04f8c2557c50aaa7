"""KKT optimality check for the graphical lasso (paper eq. (11)-(12)).

    W = Theta^{-1}
    |S_ij - W_ij| <= lam            where Theta_ij  = 0          (11)
    W_ij = S_ij + lam*sign(Theta_ij) where Theta_ij != 0          (12)
    W_ii = S_ii + lam

``kkt_residual`` returns the worst violation across all three groups, for
one matrix or a batch of them, with ``torch.linalg`` on the tensors' own
device.  The reference computes this outside any TPU kernel, so a library
inverse is its counterpart here.
"""

from __future__ import annotations

import torch


def kkt_residual(
    S: torch.Tensor, Theta: torch.Tensor, lam, *, zero_tol: float = 1e-9
) -> torch.Tensor:
    """Worst KKT violation of Theta for (..., b, b) inputs; ``lam`` is a
    scalar or one value per matrix.  A singular Theta gives inf."""
    lam = torch.as_tensor(lam, dtype=S.dtype, device=S.device)
    lam_m = lam[..., None, None]
    W, info = torch.linalg.inv_ex(Theta)
    eye = torch.eye(S.shape[-1], dtype=torch.bool, device=S.device)
    is_zero = Theta.abs() <= zero_tol
    v_zero = torch.where(
        is_zero & ~eye, torch.clamp((S - W).abs() - lam_m, min=0.0), 0.0
    ).amax(dim=(-2, -1))
    v_act = torch.where(
        ~is_zero & ~eye, (W - S - lam_m * torch.sign(Theta)).abs(), 0.0
    ).amax(dim=(-2, -1))
    v_diag = (
        W.diagonal(dim1=-2, dim2=-1) - S.diagonal(dim1=-2, dim2=-1) - lam[..., None]
    ).abs().amax(dim=-1)
    res = torch.maximum(torch.maximum(v_zero, v_act), v_diag)
    return torch.where(info == 0, res, torch.full_like(res, float("inf")))
