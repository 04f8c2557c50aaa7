"""KKT optimality check for the graphical lasso (paper eq. (11)-(12)).

    W = Theta^{-1}
    |S_ij - W_ij| <= lam            where Theta_ij  = 0          (11)
    W_ij = S_ij + lam*sign(Theta_ij) where Theta_ij != 0          (12)
    W_ii = S_ii + lam

``kkt_residual`` returns the worst violation across all three groups, for
one matrix or a batch of them, with ``torch.linalg`` on the tensors' own
device.  The reference computes this outside any TPU kernel, so a library
inverse is its counterpart here.

``kkt_residual_sparse`` is the block-sparse twin: per-component residuals
against gathered S blocks, never a global (p, p) product.
``glasso_objective`` is the penalized negative log-likelihood itself.
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


def kkt_residual_sparse(S, Theta, lam: float) -> float:
    """Worst KKT violation of a block-sparse result, block by block.

    ``Theta`` is a ``repro_torch.core.sparse.SparseTheta``; ``S`` is
    anything the covariance gather protocol accepts (dense array or a
    materialized streamed covariance).  Per non-singleton component: gather
    S[C, C] and take the host residual (eq. (11)-(12)); isolated vertices
    check their closed form W_ii = 1/Theta_ii = S_ii + lam exactly.

    Cross-component entries need no arithmetic: Theorem 1's screen
    guarantees |S_ij| <= lam there, and the block-diagonal Theta gives
    W_ij = 0, so condition (11) holds by construction — which is why this
    verifier never allocates a (p, p) buffer (the ``result.bytes_peak``
    watermark records the largest per-block working set instead)."""
    import numpy as np

    from repro_torch.core.blocks import gather_diag, gather_submatrix
    from repro_torch.core.instrument import set_peak
    from repro_torch.core.solvers.closed_form import kkt_residual_host

    worst = 0.0
    for c, blk in Theta.blocks():
        Sb = gather_submatrix(S, c, dtype=np.float64)
        # working set: S block, Theta block, W = inv(Theta) block
        set_peak("result.bytes_peak", int(3 * Sb.nbytes))
        worst = max(worst, kkt_residual_host(Sb, float(lam), np.asarray(blk)))
    iso = Theta.isolated
    if iso.size:
        d = np.asarray(gather_diag(S, iso), dtype=np.float64)
        vals = np.asarray(Theta.isolated_values, dtype=np.float64)
        worst = max(worst, float(np.abs(1.0 / vals - d - float(lam)).max()))
    return float(worst)


def glasso_objective(S: torch.Tensor, Theta: torch.Tensor, lam) -> torch.Tensor:
    """-logdet(Theta) + tr(S Theta) + lam * ||Theta||_1 (diagonal
    included), for (..., b, b) inputs; inf where Theta is not positive
    definite."""
    sign, logdet = torch.linalg.slogdet(Theta)
    lam = torch.as_tensor(lam, dtype=S.dtype, device=S.device)
    obj = -logdet + (S * Theta).sum(dim=(-2, -1)) + lam * Theta.abs().sum(dim=(-2, -1))
    return torch.where(sign > 0, obj, torch.full_like(obj, float("inf")))
