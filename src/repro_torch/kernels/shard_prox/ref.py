"""Plain PyTorch version of the fused prox tail of the ADMM solvers.

One ADMM iteration (the sharded oversize solver's, and the dense ``admm``
solver's Z/U update) ends with four elementwise passes over the iterate:

    A      = X_new + U                       (prox argument)
    Z_new  = soft(A, t),  t = lam / rho      (diagonal penalized too — the
                                              full-L1 convention of eq. (1))
    U_new  = A - Z_new                       (scaled-dual update, the same
                                              bits as U + X_new - Z_new)
    rp2    = sum((X_new - Z_new)^2)          (primal-residual partial)
    rd2    = sum((Z_new - Z_old)^2)          (dual-residual partial,
                                              scaled by rho at the call site)

``fused_prox_ref`` takes one (rl, b) row shard with a scalar t — the
reference's ``fused_prox_ref`` — or an (N, rl, b) stack of lanes with t a
scalar or one value per lane (N,), returning per-lane rp2 and rd2 (N,).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.prox_l1.ref import per_lane


def fused_prox_ref(
    x_new: torch.Tensor, u: torch.Tensor, z_old: torch.Tensor, t
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (Z_new, U_new, rp2, rd2); rp2 and rd2 are 0-d for a shard and
    (N,) for a stack."""
    t = per_lane(t, x_new)
    a = x_new + u
    z_new = torch.sign(a) * torch.clamp(a.abs() - t, min=0.0)
    u_new = a - z_new
    dims = (-2, -1)
    rp2 = ((x_new - z_new) ** 2).sum(dim=dims)
    rd2 = ((z_new - z_old) ** 2).sum(dim=dims)
    return z_new, u_new, rp2, rd2
