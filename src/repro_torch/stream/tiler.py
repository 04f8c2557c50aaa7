"""Moments pass and the tile-pair schedule of the streaming screener.

The MOMENTS PASS (``column_moments``) is one numpy sweep over row chunks of
X: the column means, the centered diagonal S_ii and the uncentered column
norms — O(p) state, chunk-at-a-time upcast, never an (n, p) copy.  It is a
copy of the reference's, so both packages skip the same tile pairs.

The tile-pair schedule implements the screener's early skip.  By
Cauchy-Schwarz, |S_ij| <= sqrt(S_ii * S_jj), so a pair of column tiles
(I, J) with  max_I sqrt(S_ii) * max_J sqrt(S_jj) * (1 + slack) <= lam  can
contain no edge of eq. (4) at any lambda >= lam and is never computed — the
paper's large-lambda regime turns most of the p^2/(2*tile^2) pairs into
zero-cost skips (``stream.tiles_skipped``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Moments:
    """O(p) sufficient statistics of one pass over X."""

    n: int
    mu: np.ndarray        # column means, f64
    diag: np.ndarray      # centered S_ii = sum((x_i - mu_i)^2) / n
    sqsum: np.ndarray     # uncentered sum x_i^2 — sqrt(G_ii) feeds the
                          # rank-k perturbation bounds of appended rows

    @property
    def norms(self) -> np.ndarray:
        """sqrt(S_ii) — the per-column Cauchy-Schwarz factors."""
        return np.sqrt(np.maximum(self.diag, 0.0))

    @property
    def gram_norms(self) -> np.ndarray:
        """sqrt(G_ii) = uncentered column 2-norms (rank-k update bounds)."""
        return np.sqrt(np.maximum(self.sqsum, 0.0))


def column_moments(X: np.ndarray, *, chunk: int = 4096) -> Moments:
    """Two chunked passes (mean, then centered square) in f64 accumulation.

    The second pass centers each chunk against the final mean, so ``diag``
    matches a dense  diag((X-mu)'(X-mu))/n  estimator to f64 roundoff (and
    exactly, on exactly-representable data)."""
    X = np.asarray(X)
    n, p = X.shape
    colsum = np.zeros(p, dtype=np.float64)
    sqsum = np.zeros(p, dtype=np.float64)
    for r0 in range(0, n, chunk):
        c = X[r0 : r0 + chunk].astype(np.float64, copy=False)
        colsum += c.sum(axis=0)
        sqsum += (c * c).sum(axis=0)
    mu = colsum / n
    css = np.zeros(p, dtype=np.float64)
    for r0 in range(0, n, chunk):
        c = X[r0 : r0 + chunk].astype(np.float64, copy=False) - mu
        css += (c * c).sum(axis=0)
    return Moments(n=n, mu=mu, diag=css / n, sqsum=sqsum)


def tile_maxima(values: np.ndarray, tile: int) -> np.ndarray:
    """Per-column-tile maximum of a (p,) vector (last tile may be short)."""
    p = values.shape[0]
    nt = -(-p // tile)
    out = np.empty(nt, dtype=np.float64)
    for t in range(nt):
        out[t] = values[t * tile : (t + 1) * tile].max(initial=0.0)
    return out


def pair_skippable(
    norms_max: np.ndarray, ti, tj, lam: float, *, slack: float
) -> np.ndarray:
    """THE skip predicate (one definition site — the screen schedule and the
    incremental re-validation must never drift apart):  a tile pair holds no
    strict eq.-(4) edge at any lambda >= lam iff
    norms_max[ti] * norms_max[tj] * (1 + slack) <= lam."""
    return norms_max[ti] * norms_max[tj] * (1.0 + slack) <= lam


def tile_pair_schedule(
    norms_max: np.ndarray, lam_min: float, *, slack: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangular tile pairs with the Cauchy-Schwarz skip applied.

    Returns (ti, tj, keep) over ALL pairs, ti <= tj: ``keep`` marks pairs
    that must be computed; ~keep pairs are provably edge-free for every
    lambda on a grid whose smallest value is lam_min (``pair_skippable``)."""
    nt = norms_max.shape[0]
    ti, tj = np.triu_indices(nt)
    keep = ~pair_skippable(norms_max, ti, tj, lam_min, slack=slack)
    return ti, tj, keep
