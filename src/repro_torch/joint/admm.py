"""ADMM for the joint multi-class graphical lasso (problem (J) in
``repro_torch.joint.screen``), over a bucket of lanes.

The splitting is the single-class one lifted to a (K, b, b) stack per
lane, with the Z-update coupled across classes:

    Theta-update:  per class, rho*Theta_k - Theta_k^{-1} = rho*(Z_k - U_k) - S_k,
                   one batched ``torch.linalg.eigh`` over the (n*K, b, b)
                   stack;
    Z-update:      the JOINT prox of lam1*l1 + lam2*P2 applied entrywise to
                   the K-vector at every (i, j) — ``kernels.joint_prox``
                   (the CUDA kernel on the card), which also returns both
                   residual partials; diagonal entries take the l1 piece;
    U-update:      U += Theta - Z (inside the same fused pass).

rho is shared across the classes of a lane and adapted online (Boyd
Section 3.4.1); the stopping rule scales the single-class eps by sqrt(K),
eps = tol * b * sqrt(K) at the PADDED size b.  Warm starts: a
(K, b, b) covariance stack W0 per lane seeds Z0 = W0^{-1} (or Theta0
directly) and U0 = (W0 - S)/rho; a lane whose seed is not finite starts
cold.

Lanes.  The reference maps a per-block ``lax.while_loop`` over the bucket
with ``jax.vmap``: each lane stops on its own condition and its carry
freezes while its neighbours iterate on.  Here the bucket iterates as one
(n, K, b, b) stack with an active mask of shape (n,) on the device;
``torch.where(active, new, old)`` keeps a finished lane's Z, U, rho,
residuals and count, so every lane keeps its own rho, adaptive factor and
iteration count.  The host reads "is any lane still active" only every
``CHECK_EVERY`` iterations: a frozen lane does not change, so the result
equals a check after every iteration; the extra iterations of a stopped
bucket change nothing.  t = [lam1/rho, lam2/rho] reaches the kernel as an
(n, 2) tensor, so no rho-dependent Python float ever leaves the device.

Returns Z — exactly sparse off-support (the prox output), symmetrized.
Registered as the ``SolverSpec`` "joint_admm" (``repro_torch.joint``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.solvers.admm import advance_lanes
from repro_torch.kernels.joint_prox.ops import joint_prox_step

#: iterations between the host's reads of "is any lane still active"
CHECK_EVERY = 16


def theta_eigh(S: torch.Tensor, Z: torch.Tensor, U: torch.Tensor, rho: torch.Tensor):
    """(eigenvalues (n*K, b), eigenvectors (n*K, b, b)) of rho*(Z - U) - S
    for S/Z/U (n, K, b, b) and rho (n,): the Theta-update's eigh."""
    n, K, b, _ = S.shape
    rhs = rho[:, None, None, None] * (Z - U) - S
    return torch.linalg.eigh(rhs.reshape(n * K, b, b))


def theta_from_eigh(d: torch.Tensor, Q: torch.Tensor, rho: torch.Tensor, shape) -> torch.Tensor:
    """Theta_k = Q diag((d + sqrt(d^2 + 4 rho)) / (2 rho)) Q', reshaped to
    the (n, K, b, b) ``shape``."""
    r = rho.repeat_interleave(shape[1])[:, None]
    theta_d = (d + torch.sqrt(d * d + 4.0 * r)) / (2.0 * r)
    return ((Q * theta_d[:, None, :]) @ Q.transpose(-1, -2)).reshape(shape)


def _per_lane(x, n: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (n,) value as an (n,) tensor of ``like``'s dtype/device."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.expand(n).contiguous() if x.ndim == 0 else x


def joint_admm_info(
    S: torch.Tensor,
    lam1,
    lam2,
    *,
    penalty: str = "group",
    rho: float = 1.0,
    max_iter: int = 2000,
    tol: float = 1e-7,
    W0: torch.Tensor | None = None,
    Theta0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint ADMM over an (n, K, b, b) bucket stack, returning (Theta
    (n, K, b, b), iterations (n,) int32); lam1/lam2 are scalars or per-lane
    (n,), W0/Theta0 optional (n, K, b, b) warm pairs."""
    n, K, b, _ = S.shape
    dev, dtype = S.device, S.dtype
    lam1 = _per_lane(lam1, n, S)
    lam2 = _per_lane(lam2, n, S)
    rho0 = torch.full((n,), float(rho), dtype=dtype, device=dev)
    lanes = (n, 1, 1, 1)

    diag = S.diagonal(dim1=2, dim2=3)  # (n, K, b)
    cold_Z = torch.diag_embed(1.0 / (diag + lam1[:, None, None]))
    if W0 is None:
        Z, U = cold_Z, torch.zeros_like(S)
    else:
        usable = torch.isfinite(W0).all(dim=(1, 2, 3))
        if Theta0 is not None:
            Z0c = Theta0
        else:  # a singular W0 (info != 0) is as unusable as a non-finite one
            Z0c, info = torch.linalg.inv_ex(W0)
            usable = usable & (info == 0).all(dim=1)
        Z0c = 0.5 * (Z0c + Z0c.transpose(-1, -2))
        usable = (usable & torch.isfinite(Z0c).all(dim=(1, 2, 3))).reshape(lanes)
        Z = torch.where(usable, Z0c, cold_Z)
        U = torch.where(usable, (W0 - S) / rho0.reshape(lanes), torch.zeros_like(S))

    eps = tol * b * math.sqrt(float(K))
    inf = torch.full((n,), math.inf, dtype=dtype, device=dev)
    state = (Z, U, rho0, inf, inf, torch.zeros(n, dtype=torch.int32, device=dev))
    active = torch.full((n,), max_iter > 0, dtype=torch.bool, device=dev)
    # every lane starts active and counts each iteration it runs, so no
    # lane is still active after max_iter iterations of the bucket
    for step in range(max_iter):
        Z, U, rho = state[:3]
        Theta = theta_from_eigh(*theta_eigh(S, Z, U, rho), rho, S.shape)
        t = torch.stack([lam1 / rho, lam2 / rho], dim=1)
        new = joint_prox_step(Theta, U, Z, t, penalty=penalty)
        state, active = advance_lanes(state, new, active, eps, max_iter)
        if (step + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break
    Z, it = state[0], state[5]
    return 0.5 * (Z + Z.transpose(-1, -2)), it


def joint_admm(
    S: torch.Tensor,
    lam1,
    lam2,
    *,
    penalty: str = "group",
    rho: float = 1.0,
    max_iter: int = 2000,
    tol: float = 1e-7,
    W0: torch.Tensor | None = None,
    Theta0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Joint solver contract ``solve(S (n, K, b, b), lam1, lam2) -> Theta``:
    the port writes out the bucket dimension the reference vmaps."""
    Theta, _ = joint_admm_info(
        S, lam1, lam2, penalty=penalty, rho=rho, max_iter=max_iter, tol=tol,
        W0=W0, Theta0=Theta0,
    )
    return Theta
