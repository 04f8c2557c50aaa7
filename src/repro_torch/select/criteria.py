"""Per-component selection criteria: Gaussian log-likelihood and EBIC.

Theorem 1 makes every path result block-diagonal over its screened
components, so the Gaussian log-likelihood decomposes exactly:

    logdet(Theta) = sum_c logdet(Theta_c)  +  sum_{iso} log(theta_ii)
    tr(S Theta)   = sum_c tr(S_c Theta_c)  +  sum_{iso} S_ii * theta_ii

Both sides are computed HERE per component — per-block slogdet plus a trace
against the gathered S block — never as a global dense product, so scoring
a sparse result costs O(sum b_i^2) like everything else on the sparse path.

``CovSource`` supplies the S blocks from either modality: a dense
covariance gathers directly; the raw (n, p) data matrix centers the needed
columns on demand (an (n, b) temporary per block — the dense (p, p) S is
never formed, matching the streaming screener's contract).

EBIC (Foygel & Drton, 2010), on the ``-2 loglik`` scale (argmin selects):

    EBIC_gamma(lam) = -n (logdet Theta - tr(S Theta))
                      + |E| log n + 4 gamma |E| log p

with |E| the off-diagonal support size; gamma = 0 recovers plain BIC and
gamma = 0.5 is the standard high-dimensional default.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.blocks import gather_diag, gather_submatrix
from repro_torch.core.components import component_lists
from repro_torch.core.sparse import SparseTheta

__all__ = ["CovSource", "loglik_terms", "gaussian_loglik", "ebic_score"]


class CovSource:
    """Per-component covariance blocks from a dense S or the raw X.

    One object, two modalities, one ``block``/``diag`` surface — the
    criteria below never learn which input produced the blocks.  From X the
    blocks are the centered Gram restriction ((X - mu)' (X - mu) / n over
    the requested columns), identical to the dense S entries up to f64
    accumulation order."""

    def __init__(self, S=None, X=None):
        if (S is None) == (X is None):
            raise ValueError("CovSource needs exactly one of S or X")
        self._S = S if S is None or hasattr(S, "gather_block") else np.asarray(S)
        self._X = None
        self.n = None
        if X is not None:
            X = np.asarray(X)
            self._X = X
            self.n = int(X.shape[0])
            self._mu = X.astype(np.float64, copy=False).mean(axis=0)

    @property
    def p(self) -> int:
        return int(self._S.shape[0] if self._S is not None else self._X.shape[1])

    def block(self, idx: np.ndarray) -> np.ndarray:
        """S[np.ix_(idx, idx)] for one component's vertex set."""
        if self._S is not None:
            return np.asarray(gather_submatrix(self._S, np.asarray(idx)))
        C = self._X[:, idx].astype(np.float64, copy=False) - self._mu[idx]
        return C.T @ C / self.n

    def diag(self, idx) -> np.ndarray:
        """S[idx, idx] for isolated vertices."""
        if self._S is not None:
            return np.asarray(gather_diag(self._S, np.asarray(idx)))
        C = self._X[:, idx].astype(np.float64, copy=False) - self._mu[idx]
        return (C * C).sum(axis=0) / self.n


def _logdet_pd(blk: np.ndarray) -> float:
    sign, val = np.linalg.slogdet(blk)
    return float(val) if sign > 0 else -np.inf


def loglik_terms(result, src: CovSource) -> tuple[float, float]:
    """(logdet Theta, tr(S Theta)) of one path result, summed per component.

    ``result`` is a ``GlassoResult`` whose Theta is dense or a
    ``SparseTheta``; ``src`` supplies the matching S blocks.  Isolated
    vertices contribute their closed-form log(theta_ii) / S_ii * theta_ii
    terms — they carry lambda dependence too."""
    Theta = result.Theta
    ld = 0.0
    tr = 0.0
    if isinstance(Theta, SparseTheta):
        for c, blk in Theta.blocks():
            ld += _logdet_pd(np.asarray(blk))
            tr += float(np.sum(src.block(c) * blk))
        if Theta.isolated.size:
            vals = np.asarray(Theta.isolated_values, dtype=np.float64)
            ld += float(np.sum(np.log(vals)))
            tr += float(np.sum(src.diag(Theta.isolated) * vals))
        return ld, tr
    Theta = np.asarray(Theta)
    for comp in component_lists(np.asarray(result.labels)):
        blk = Theta[np.ix_(comp, comp)]
        if comp.size == 1:
            v = float(blk[0, 0])
            ld += np.log(v) if v > 0 else -np.inf
            tr += float(src.diag(comp)[0]) * v
        else:
            ld += _logdet_pd(blk)
            tr += float(np.sum(src.block(comp) * blk))
    return ld, tr


def gaussian_loglik(result, src: CovSource, n: int) -> float:
    """Gaussian log-likelihood (n/2)(logdet Theta - tr(S Theta)), dropping
    the data-independent constant — the quantity CV evaluates on held-out
    covariance blocks."""
    ld, tr = loglik_terms(result, src)
    return 0.5 * float(n) * (ld - tr)


def ebic_score(result, src: CovSource, n: int, *, gamma: float = 0.5) -> float:
    """Extended BIC of one path result (lower is better; argmin selects)."""
    if n is None or n <= 0:
        raise ValueError("EBIC needs the sample count n > 0")
    if gamma < 0:
        raise ValueError(f"EBIC gamma must be >= 0, got {gamma}")
    ld, tr = loglik_terms(result, src)
    n_edges = int(result.support_edges().shape[0])
    p = int(result.Theta.shape[0])
    return float(
        -n * (ld - tr) + n_edges * (np.log(n) + 4.0 * gamma * np.log(p))
    )
