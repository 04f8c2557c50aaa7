"""GLASSO block coordinate descent [Friedman, Hastie, Tibshirani 2007].

Maintains W ~= Theta^{-1}.  One sweep updates every row/column j:

    beta_j = argmin_beta  1/2 beta' W11 beta - beta' s12 + lam ||beta||_1   (9)
    w12    = W11 beta_j

with the inner lasso solved by cyclic coordinate descent, the eq.-(10) node
screen ||s12||_inf <= lam => beta_j = 0 explicit, and Theta recovered
column-wise at convergence.

The port's solver IS the ``bucket_glasso`` kernel: a bucket stack solves in
one ``fused_bcd_stack`` launch.  Cold lanes get the pair W0 = S + lam*I,
Theta0 = I, which reproduces the cold start exactly; the convergence scale
is mean|S - diag S| + 1e-12 of each padded block, as the reference computes
it inside ``glasso_bcd``.
"""

from __future__ import annotations

import torch

from repro_torch.core.solvers.protocol import one_block
from repro_torch.kernels.bucket_glasso.ops import fused_bcd_stack


def convergence_scale(blocks: torch.Tensor) -> torch.Tensor:
    """Per-lane mean|S - diag S| + 1e-12 at the stack's (padded) size."""
    off = blocks - torch.diag_embed(blocks.diagonal(dim1=1, dim2=2))
    return off.abs().mean(dim=(1, 2)) + 1e-12


def glasso_bcd_stack(
    blocks: torch.Tensor,
    lams: torch.Tensor,
    *,
    max_sweeps: int = 100,
    n_cd: int = 100,
    tol: float = 1e-6,
    node_screen: bool = True,
    W0: torch.Tensor | None = None,
    Theta0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Solve every (b, b) block of a (N, b, b) stack; returns Theta.

    ``W0`` warm-starts the covariance iterate (default: the cold start
    S + lam*I); ``Theta0`` seeds the inner-lasso coefficients
    beta_j = -Theta0[:, j] / Theta0[j, j] (default I: beta = 0)."""
    N, b, _ = blocks.shape
    eye = torch.eye(b, dtype=blocks.dtype, device=blocks.device)
    if W0 is None:
        W0 = blocks + lams[:, None, None] * eye
    if Theta0 is None:
        Theta0 = eye.expand(N, b, b)
    theta, _ = fused_bcd_stack(
        blocks, lams, convergence_scale(blocks), W0, Theta0,
        max_sweeps=max_sweeps, n_cd=n_cd, tol=tol, node_screen=node_screen,
    )
    return theta


def glasso_bcd(
    S,
    lam,
    *,
    max_sweeps: int = 100,
    n_cd: int = 100,
    tol: float = 1e-6,
    node_screen: bool = True,
    W0=None,
    Theta0=None,
    device=None,
) -> torch.Tensor:
    """Solve the graphical lasso on one (b, b) block; returns Theta: one
    lane of ``glasso_bcd_stack`` (one ``bucket_glasso`` launch on the
    card).  ``device``: see ``protocol.one_block`` (an array S runs on the
    card unless ``device="cpu"``)."""
    S1, lams, W1, T1 = one_block(S, lam, W0, Theta0, device)
    return glasso_bcd_stack(
        S1, lams, max_sweeps=max_sweeps, n_cd=n_cd, tol=tol,
        node_screen=node_screen, W0=W1, Theta0=T1,
    )[0]
