"""Lambda grids: the ONE normalization chokepoint.

Every path surface funnels its grid through ``normalize_lambda_grid``: sort
descending (the Theorem-2 direction), dedupe exactly, reject non-positive
or non-finite values.  ``lambda_max`` is the top of any useful grid,

    lambda_max = max_{i != j} |S_ij|

— the smallest lambda at which the strict threshold (eq. 4) screens every
vertex into a singleton.  Pure numpy, so the stream and engine layers import
it without cycles.
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_lambda_grid", "lambda_max"]


def normalize_lambda_grid(lambdas) -> list[float]:
    """Canonicalize a lambda grid: strictly descending floats, deduped.

    Raises ``ValueError`` on an empty grid and on any non-finite or
    non-positive value — lam <= 0 makes the strict threshold |S_ij| > lam
    vacuous (and the penalized objective unregularized)."""
    vals = [float(v) for v in np.asarray(list(lambdas), dtype=object).ravel()]
    if not vals:
        raise ValueError("empty lambda grid")
    for v in vals:
        if not np.isfinite(v) or v <= 0.0:
            raise ValueError(
                f"lambda grid values must be finite and positive, got {v!r}"
            )
    return sorted(set(vals), reverse=True)


def lambda_max(S) -> float:
    """max off-diagonal |S_ij| of a dense covariance — the grid anchor.

    Scans row-wise so no (p, p) temporary beyond the input is created."""
    S = np.asarray(S)
    p = S.shape[0]
    if p < 2:
        return 0.0
    best = 0.0
    for i in range(p):
        row = np.abs(S[i].astype(np.float64))  # copy: never mutate S
        row[i] = 0.0
        best = max(best, float(row.max()))
    return best
