"""Closed-form glasso solvers for structured thresholded supports.

The routing ladder sends each component to the cheapest solver its structure
admits:

    singleton   Theta_ii = 1/(S_ii + lam)                (diagonal KKT)
    pair, tree  Fattahi-Sojoudi forest closed form (kernels/tree_glasso)
    chordal     clique-tree inverse of the maximum-determinant completion
                (Fattahi, Zhang & Sojoudi, arXiv:1711.09131):
                    Theta = sum_cliques [A_C^{-1}]^0 - sum_seps [A_S^{-1}]^0
                with A the soft-thresholded matrix restricted to the chordal
                support; host numpy, sum |C|^3 over maximal cliques.
    general     the iterative tail (bcd)

Closed forms satisfy the edge KKT exactly by construction; the non-edge dual
constraint |W_ij - S_ij| <= lam can fail on adversarial matrices, so every
fast path is verified — ``kkt_ok_stack`` / ``kkt_residual_host`` — and
failures fall back to the iterative solver.  Routing never changes the
answer, only the cost.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.solvers.kkt import kkt_residual
from repro_torch.core.solvers.protocol import one_block
from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack

__all__ = [
    "glasso_forest",
    "glasso_forest_stack",
    "glasso_chordal_host",
    "soft_threshold_host",
    "kkt_ok_stack",
    "kkt_residual_host",
]


def glasso_forest(S, lam, *, W0=None, tol=None, device=None) -> torch.Tensor:
    """Single-block contract ``solve(S, lam) -> Theta`` of the forest
    closed form: one lane of ``glasso_forest_stack`` (W0 and tol accepted
    for parity and ignored: the solve is direct); ``device`` as in
    ``protocol.one_block``."""
    del W0, tol
    S1, lams, _, _ = one_block(S, lam, device=device)
    return glasso_forest_stack(S1, lams)[0]


def soft_threshold_host(S: np.ndarray, lam: float) -> np.ndarray:
    """A = soft(S, lam) off-diagonal (strict support |S_ij| > lam),
    S_ii + lam on the diagonal — the matrix whose completion glasso inverts."""
    S = np.asarray(S)
    absS = np.abs(S)
    A = np.where(absS > lam, np.sign(S) * (absS - lam), 0.0)
    np.fill_diagonal(A, np.diag(S) + lam)
    return A


def glasso_chordal_host(
    S_blk: np.ndarray, lam: float, *, adj: np.ndarray | None = None
) -> np.ndarray:
    """Closed-form glasso candidate for one block with chordal support:
    zero-padded clique inverses minus separator inverses of the
    soft-thresholded matrix.  The caller verifies the KKT residual."""
    from repro_torch.engine.structure import (
        clique_tree,
        component_adjacency,
        peo_or_none,
    )

    S_blk = np.asarray(S_blk, dtype=np.float64 if S_blk.dtype.kind != "f" else S_blk.dtype)
    b = S_blk.shape[0]
    if adj is None:
        adj = component_adjacency(S_blk, np.arange(b), lam)
    order = peo_or_none(adj)
    if order is None:
        raise ValueError("glasso_chordal_host called on a non-chordal support")
    cliques, separators = clique_tree(adj, order)
    A = soft_threshold_host(S_blk, lam)
    Theta = np.zeros_like(A)
    for C in cliques:
        Theta[np.ix_(C, C)] += np.linalg.inv(A[np.ix_(C, C)])
    for sep in separators:
        Theta[np.ix_(sep, sep)] -= np.linalg.inv(A[np.ix_(sep, sep)])
    return Theta


#: closed-form candidates are EXACTLY sparse off their support, so the zero
#: classification can be much tighter than the iterative solvers' default
_ZERO_TOL = 1e-12


def kkt_ok_stack(
    blocks: torch.Tensor, lams: torch.Tensor, thetas: torch.Tensor, *, tol: float
) -> torch.Tensor:
    """Per-block bool: candidates within ``tol`` (scaled by max(1, max|S|))
    of KKT optimality.  A candidate that is not positive definite fails."""
    res = kkt_residual(blocks, thetas, lams, zero_tol=_ZERO_TOL)
    pd = torch.linalg.slogdet(thetas)[0] > 0
    res = torch.where(pd, res, torch.full_like(res, float("inf")))
    scale = torch.clamp(blocks.abs().amax(dim=(1, 2)), min=1.0)
    return res <= tol * scale


def kkt_residual_host(S: np.ndarray, lam: float, Theta: np.ndarray) -> float:
    """Numpy twin of ``kkt_residual`` for the chordal (host) path."""
    S = np.asarray(S, dtype=np.float64)
    Theta = np.asarray(Theta, dtype=np.float64)
    sign, _ = np.linalg.slogdet(Theta)
    if not np.isfinite(Theta).all() or sign <= 0:
        return float("inf")
    W = np.linalg.inv(Theta)
    eye = np.eye(S.shape[0], dtype=bool)
    is_zero = np.abs(Theta) <= _ZERO_TOL
    v_zero = np.where(
        is_zero & ~eye, np.maximum(np.abs(S - W) - lam, 0.0), 0.0
    ).max()
    v_act = np.where(
        ~is_zero & ~eye, np.abs(W - S - lam * np.sign(Theta)), 0.0
    ).max()
    v_diag = np.abs(np.diag(W) - np.diag(S) - lam).max()
    return float(max(v_zero, v_act, v_diag))
