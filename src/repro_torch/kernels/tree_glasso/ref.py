"""Plain PyTorch closed-form glasso on an acyclic thresholded support.

Fattahi & Sojoudi (arXiv:1708.09479): when the support of the soft-thresholded
covariance is a forest, the glasso optimum is explicit.  With the full-L1
convention (diagonal penalized, so W_ii = S_ii + lam) define

    d_i  = S_ii + lam
    a_ij = soft(S_ij, lam)            on edges |S_ij| > lam (strict, eq. (4))
    D_ij = d_i d_j - a_ij^2

and the optimum is

    Theta_ij = -a_ij / D_ij                          (i, j) an edge
    Theta_ii = 1/d_i + sum_{j ~ i} a_ij^2 / (d_i D_ij)
    Theta_ij = 0                                     otherwise.

Padded bucket coordinates (identity-padded S, no edges) come out as
1/(1 + lam) on the diagonal — the padded glasso solution — so the formula
applies verbatim to the planner's padded block stacks.  Exactness needs the
thresholded and solution supports to coincide; the executor verifies the
KKT residual and falls back to the iterative tail.
"""

from __future__ import annotations

import torch


def glasso_forest_ref(S: torch.Tensor, lam) -> torch.Tensor:
    """Closed-form glasso of a (..., b, b) stack; ``lam`` is a scalar or one
    value per block (shape ``S.shape[:-2]``)."""
    b = S.shape[-1]
    lam = torch.as_tensor(lam, dtype=S.dtype, device=S.device)[..., None, None]
    eye = torch.eye(b, dtype=torch.bool, device=S.device)
    absS = S.abs()
    mask = (absS > lam) & ~eye
    a = torch.where(mask, torch.sign(S) * (absS - lam), 0.0)
    d = S.diagonal(dim1=-2, dim2=-1) + lam[..., 0]
    den = torch.where(mask, d[..., :, None] * d[..., None, :] - a * a, 1.0)
    theta_off = torch.where(mask, -a / den, 0.0)
    contrib = torch.where(mask, (a * a) / (d[..., :, None] * den), 0.0)
    theta_diag = 1.0 / d + contrib.sum(dim=-1)
    return theta_off + torch.where(eye, theta_diag[..., :, None], 0.0)
