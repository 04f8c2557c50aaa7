"""G-ISTA-style proximal gradient for the graphical lasso, over a bucket.

First-order stand-in for SMACS [Lu 2010] (same O(b^3)-per-iteration class —
one Cholesky + solve per step):

    grad f(Theta) = S - Theta^{-1}
    Theta+ = soft(Theta - t * grad, t * lam)        (diagonal penalized too)

with backtracking on t: accept when Theta+ is PD (Cholesky succeeds) and the
quadratic upper bound holds.  The first candidate of an iteration tries
twice the carried step, each rejection halves it, the line search returns
half the last step tried, and the next iteration carries
clip(4 * that, 1e-12, 1e6).  The candidate is the ``prox_l1`` kernel's
step (its plain version on the CPU).

Lanes.  The reference maps a per-block solve of nested ``while_loop``s over
the bucket with ``jax.vmap``.  Here the (N, b, b) bucket iterates as one
stack with two (N,) masks on the device — lanes still iterating, and lanes
still searching for a step — and ``torch.where`` freezes every other lane,
so each lane keeps its own step, iterate and count.  The host reads "is any
lane still iterating, is any still searching" once an iteration, after its
first candidate (an iteration that finds no lane iterating changes nothing
and ends the loop), and "is any lane still searching" after each further
line-search step.
"""

from __future__ import annotations

import torch

from repro_torch.core.solvers.protocol import one_block
from repro_torch.kernels.prox_l1.ops import prox_step


def chol_logdet_inv(Theta: torch.Tensor, *, inverse: bool = True):
    """(is_pd (N,), logdet (N,), Theta^{-1} (N, b, b)) via one batched
    Cholesky of the symmetrized stack (as JAX's ``cholesky`` factors
    (Theta + Theta')/2).  A lane that is not PD (``info != 0`` or a
    non-finite factor) gets the identity factor: logdet 0, inverse I.
    ``inverse=False`` skips the inverse (None): a line-search candidate
    needs only its PD test and logdet."""
    b = Theta.shape[-1]
    L, info = torch.linalg.cholesky_ex(0.5 * (Theta + Theta.mT))
    ok = (info == 0) & torch.isfinite(L).all(dim=(1, 2))
    eye = torch.eye(b, dtype=Theta.dtype, device=Theta.device)
    Ls = torch.where(ok[:, None, None], L, eye)
    diag = Ls.diagonal(dim1=1, dim2=2)
    logdet = 2.0 * torch.log(torch.clamp(diag, min=1e-30)).sum(dim=1)
    inv = torch.cholesky_solve(eye.expand_as(Ls), Ls) if inverse else None
    return ok, logdet, inv


def _f_val(S: torch.Tensor, logdet: torch.Tensor, Theta: torch.Tensor) -> torch.Tensor:
    return -logdet + (S * Theta).sum(dim=(1, 2))


def glasso_pg_stack(
    blocks: torch.Tensor,
    lams: torch.Tensor,
    *,
    max_iter: int = 1000,
    ls_iter: int = 30,
    tol: float = 1e-7,
    W0: torch.Tensor | None = None,  # API parity; pg warm-starts from Theta0
    Theta0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Solve every (b, b) block of an (N, b, b) stack; returns the
    symmetrized Theta stack.  ``lams`` is (N,); ``Theta0`` an optional
    (N, b, b) starting iterate (default diag(1/(S_ii + lam)))."""
    del W0
    S = blocks
    N, b, _ = S.shape
    dev, dtype = S.device, S.dtype
    lam = lams.to(dtype)
    if Theta0 is None:
        Theta = torch.diag_embed(1.0 / (S.diagonal(dim1=1, dim2=2) + lam[:, None]))
    else:
        Theta = Theta0.to(dtype)
    t = 1.0 / (torch.linalg.matrix_norm(S) + 1.0)
    delta = torch.full((N,), float("inf"), dtype=dtype, device=dev)
    it = torch.zeros(N, dtype=torch.int32, device=dev)
    active = (delta > tol) & (it < max_iter)

    def try_step(t_try, Theta, grad, fcur):
        cand = prox_step(Theta, grad, t_try, lam)
        okc, logdetc, _ = chol_logdet_inv(cand, inverse=False)
        diff = cand - Theta
        quad = fcur + (grad * diff).sum(dim=(1, 2)) + (diff * diff).sum(dim=(1, 2)) / (2.0 * t_try)
        return cand, okc & (_f_val(S, logdetc, cand) <= quad + 1e-12)

    for _ in range(max_iter):
        _, logdet, inv = chol_logdet_inv(Theta)
        grad = S - inv
        fcur = _f_val(S, logdet, Theta)
        # the first candidate tries 2t; the search carries (t_cur, cand,
        # good, k) per lane and halves t_cur after every candidate
        t_cur = 2.0 * t
        cand, good = try_step(t_cur, Theta, grad, fcur)
        t_cur = 0.5 * t_cur
        k = torch.zeros(N, dtype=torch.int32, device=dev)
        searching = active & ~good & (k < ls_iter)
        any_search, any_active = torch.stack([searching.any(), active.any()]).tolist()
        if not any_active:
            break
        while any_search:
            c_new, g_new = try_step(t_cur, Theta, grad, fcur)
            cand = torch.where(searching[:, None, None], c_new, cand)
            good = torch.where(searching, g_new, good)
            t_cur = torch.where(searching, 0.5 * t_cur, t_cur)
            k = k + searching.to(k.dtype)
            searching = searching & ~good & (k < ls_iter)
            any_search = bool(searching.any())
        new = torch.where(good[:, None, None], cand, Theta)
        d_new = (new - Theta).abs().amax(dim=(1, 2))
        a3 = active[:, None, None]
        Theta = torch.where(a3, new, Theta)
        t = torch.where(active, torch.clamp(4.0 * t_cur, 1e-12, 1e6), t)
        delta = torch.where(active, d_new, delta)
        it = it + active.to(it.dtype)
        active = active & (delta > tol) & (it < max_iter)
    return 0.5 * (Theta + Theta.mT)


def glasso_pg(
    S,
    lam,
    *,
    max_iter: int = 1000,
    ls_iter: int = 30,
    tol: float = 1e-7,
    W0=None,  # API parity; pg warm-starts from Theta0
    Theta0=None,
    device=None,
) -> torch.Tensor:
    """Single-block contract ``solve(S, lam, **opts) -> Theta``: one lane
    of ``glasso_pg_stack``; ``device`` as in ``protocol.one_block``."""
    S1, lams, _, T1 = one_block(S, lam, None, Theta0, device)
    return glasso_pg_stack(
        S1, lams, max_iter=max_iter, ls_iter=ls_iter, tol=tol, Theta0=T1
    )[0]
