"""ADMM for the graphical lasso [Boyd et al. 2011, Section 6.5], over a
bucket.

    Theta-update:  rho*Theta - Theta^{-1} = rho*(Z - U) - S
                   -> eigendecompose the RHS, theta_i = (d_i + sqrt(d_i^2 + 4 rho)) / (2 rho)
    Z-update:      Z = soft(Theta + U, lam/rho)      (diagonal penalized too)
    U-update:      U += Theta - Z

The Theta-update is one batched ``torch.linalg.eigh`` of the (N, b, b)
right-hand sides (symmetrized first, as JAX's ``eigh`` does); the Z- and
U-updates and both residual norms are one ``shard_prox`` launch over the
stack with t = lam/rho per lane (its plain version on the CPU).  Returns Z
(the sparse iterate), symmetrized, so the support is exactly sparse.

rho is adapted online per lane (Boyd Section 3.4.1: x2 when the primal
residual runs 10x ahead of the dual, /2 in the opposite case, with the
scaled dual U rescaled accordingly); the loop stops when both residuals are
below eps = tol * b at the padded size b.

WARM STARTS: ``W0`` (a covariance iterate per lane, W ~= Theta*^{-1})
seeds both halves of the splitting, Z0 = W0^{-1} (or ``Theta0`` directly
when the caller holds it) and U0 = (W0 - S) / rho: an exact W0 is then a
fixed point and a near-solution converges in a handful of sweeps.  A lane
whose seed is singular or not finite starts cold.

Lanes.  The reference maps a per-block ``while_loop`` over the bucket with
``jax.vmap``; here the bucket iterates as one stack with an (N,) active
mask on the device, and ``torch.where`` freezes a finished lane's Z, U,
rho, residuals and count.  The host reads "is any lane still active" every
``CHECK_EVERY`` iterations: a frozen lane does not change, so the result
equals a check after every iteration.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.solvers.protocol import one_block
from repro_torch.kernels.shard_prox.ops import fused_prox_residual

#: iterations between the host's reads of "is any lane still active"
CHECK_EVERY = 16


def theta_update(
    S: torch.Tensor, Z: torch.Tensor, U: torch.Tensor, rho: torch.Tensor
) -> torch.Tensor:
    """Theta = Q diag((d + sqrt(d^2 + 4 rho)) / (2 rho)) Q' for the
    eigendecomposition Q diag(d) Q' of rho*(Z - U) - S, per lane.

    Memory: the right-hand side is built and symmetrized in one buffer, and
    eigh runs in place on it: the symmetric buffer's column-major view
    holds the values of the column-major copy eigh would otherwise make, so
    handing that view as both input and output skips the copy — the same
    library call on the same values, the same bits.  During eigh only S,
    Z, U, that buffer and eigh's workspace are live."""
    rhs = (Z - U).mul_(rho[:, None, None]).sub_(S)
    V = _symmetrize_(rhs).mT
    d = torch.empty(V.shape[:-1], dtype=V.dtype, device=V.device)
    d, Q = torch.linalg.eigh(V, out=(d, V))
    r1 = rho[:, None]
    theta_d = (d + torch.sqrt(d * d + 4.0 * r1)) / (2.0 * r1)
    return (Q * theta_d[:, None, :]) @ Q.mT


def _symmetrize_(a: torch.Tensor) -> torch.Tensor:
    """a <- 0.5 * (a + a') in place, 256 rows at a time: each step writes
    rows [i0, i1) up to column i1 and the mirror columns, reading only
    entries no earlier step has written, so every entry gets exactly
    0.5 * (a_ij + a_ji).  The scratch is (N, 256, b), not (N, b, b)."""
    b = a.shape[-1]
    for i0 in range(0, b, 256):
        i1 = min(i0 + 256, b)
        sym = (a[:, i0:i1, :i1] + a[:, :i1, i0:i1].mT).mul_(0.5)
        a[:, i0:i1, :i1] = sym
        a[:, :i1, i0:i1] = sym.mT
    return a


def advance_lanes(state, new, active: torch.Tensor, eps: float, max_iter: int):
    """One iteration's bookkeeping over the lanes: the adaptive rho step and
    the freeze of finished lanes.  ``state`` is (Z, U, rho, r_prim, r_dual,
    it) with Z/U stacks of any trailing shape over (n,) lanes, ``new`` the
    prox step's (Z_new, U_new, rp2, rd2); returns the next (state, active).
    Shared with the joint ADMM, whose lanes are (K, b, b) stacks.

    ``new``'s Z/U stacks become the next state's in place (a finished
    lane's old values copied back into them), so no third pair of stacks
    is allocated; the caller drops the old pair."""
    Z, U, rho, r_prim, r_dual, it = state
    Z_new, U_new, rp2, rd2 = new
    rp_new = torch.sqrt(rp2)
    rd_new = rho * torch.sqrt(rd2)
    # adaptive rho; U is the SCALED dual, so it rescales inversely
    one = torch.ones_like(rho)
    factor = torch.where(
        rp_new > 10.0 * rd_new, 2.0 * one, torch.where(rd_new > 10.0 * rp_new, 0.5 * one, one)
    )
    lanes = (-1,) + (1,) * (Z.ndim - 1)
    a = active.reshape(lanes)
    state = (
        torch.where(a, Z_new, Z, out=Z_new),
        torch.where(a, U_new.div_(factor.reshape(lanes)), U, out=U_new),
        torch.where(active, rho * factor, rho),
        torch.where(active, rp_new, r_prim),
        torch.where(active, rd_new, r_dual),
        it + active.to(it.dtype),
    )
    active = active & ((state[3] > eps) | (state[4] > eps)) & (state[5] < max_iter)
    return state, active


def glasso_admm_info(
    blocks: torch.Tensor,
    lams: torch.Tensor,
    *,
    rho: float = 1.0,
    max_iter: int = 2000,
    tol: float = 1e-7,
    W0: torch.Tensor | None = None,
    Theta0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ADMM over an (N, b, b) stack, returning (Theta (N, b, b), iterations
    (N,) int32); ``lams`` is (N,), W0/Theta0 optional (N, b, b) warm
    pairs."""
    S = blocks
    N, b, _ = S.shape
    dev, dtype = S.device, S.dtype
    lam = lams.to(dtype)
    rho0 = torch.full((N,), float(rho), dtype=dtype, device=dev)
    cold_Z = torch.diag_embed(1.0 / (S.diagonal(dim1=1, dim2=2) + lam[:, None]))
    if W0 is None:
        Z, U = cold_Z, torch.zeros_like(S)
    else:
        usable = torch.isfinite(W0).all(dim=(1, 2))
        if Theta0 is not None:
            Z0c = Theta0
        else:  # a singular W0 (info != 0) is as unusable as a non-finite one
            Z0c, info = torch.linalg.inv_ex(W0)
            usable = usable & (info == 0)
        Z0c = 0.5 * (Z0c + Z0c.mT)
        usable = (usable & torch.isfinite(Z0c).all(dim=(1, 2)))[:, None, None]
        Z = torch.where(usable, Z0c, cold_Z)
        U = torch.where(usable, (W0 - S) / rho0[:, None, None], torch.zeros_like(S))
        del Z0c
    del cold_Z  # the loop holds one (Z, U) pair at a time

    eps = tol * b
    inf = torch.full((N,), math.inf, dtype=dtype, device=dev)
    state = (Z, U, rho0, inf, inf, torch.zeros(N, dtype=torch.int32, device=dev))
    active = torch.full((N,), max_iter > 0, dtype=torch.bool, device=dev)
    # every lane starts active and counts each iteration it runs, so no
    # lane is still active after max_iter iterations of the bucket
    del Z, U
    for step in range(max_iter):
        Z, U, rho = state[:3]
        new = fused_prox_residual(theta_update(S, Z, U, rho), U, Z, lam / rho)
        del Z, U
        state, active = advance_lanes(state, new, active, eps, max_iter)
        del new
        if (step + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break
    Z, it = state[0], state[5]
    del state
    return (Z + Z.mT).mul_(0.5), it


def glasso_admm_stack(
    blocks: torch.Tensor,
    lams: torch.Tensor,
    *,
    rho: float = 1.0,
    max_iter: int = 2000,
    tol: float = 1e-7,
    W0: torch.Tensor | None = None,
    Theta0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched solver contract ``fn(blocks, lams, **opts) -> Theta``."""
    Theta, _ = glasso_admm_info(
        blocks, lams, rho=rho, max_iter=max_iter, tol=tol, W0=W0, Theta0=Theta0
    )
    return Theta


def glasso_admm(
    S,
    lam,
    *,
    rho: float = 1.0,
    max_iter: int = 2000,
    tol: float = 1e-7,
    W0=None,
    Theta0=None,
    device=None,
) -> torch.Tensor:
    """Single-block contract ``solve(S, lam, **opts) -> Theta``: one lane
    of ``glasso_admm_stack``; ``device`` as in ``protocol.one_block``."""
    S1, lams, W1, T1 = one_block(S, lam, W0, Theta0, device)
    return glasso_admm_stack(
        S1, lams, rho=rho, max_iter=max_iter, tol=tol, W0=W1, Theta0=T1
    )[0]
