"""Plain PyTorch version of the proximal-gradient step of the ``pg`` solver:

    out = soft(theta - t * grad, t * lam)

over a (B, b, b) stack of blocks (or one (b, b) block), where
grad = S - Theta^{-1} is the smooth gradient, computed outside.  ``t`` and
``lam`` are scalars or one value per block, shape (B,): the port's batched
``pg`` runs one backtracking line search per lane, so each lane tries its
own step.  For a scalar t it is the reference's ``prox_step_ref``
operation for operation.
"""

from __future__ import annotations

import torch


def per_lane(x, theta: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) ``x`` shaped to broadcast over ``theta``: a 0-d
    tensor for a scalar, (B, 1, 1) for per-lane values of a stack."""
    x = torch.as_tensor(x, dtype=theta.dtype, device=theta.device)
    return x if x.ndim == 0 else x.reshape(-1, *([1] * (theta.ndim - 1)))


def prox_step_ref(theta: torch.Tensor, grad: torch.Tensor, t, lam) -> torch.Tensor:
    t = per_lane(t, theta)
    lam = per_lane(lam, theta)
    z = theta - t * grad
    thr = t * lam
    return torch.sign(z) * torch.clamp(z.abs() - thr, min=0.0)
