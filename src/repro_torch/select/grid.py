"""Lambda grids: the ONE normalization chokepoint + the auto grid.

Every path surface (``glasso_path``, ``Engine.run_path``, ``stream_screen``,
``plan_path_streaming``, ``select_path``) funnels its grid through
``normalize_lambda_grid``: sort descending (the Theorem-2 direction), dedupe
exactly, reject non-positive or non-finite values.  ``lambda_grid`` builds
the standard log-spaced grid anchored at

    lambda_max = max_{i != j} |S_ij|

— the smallest lambda at which the strict threshold (eq. 4) screens every
vertex into a singleton.  From the raw data matrix
(``lambda_max_from_data``) it is computed exactly without forming S: the
per-tile Cauchy-Schwarz bounds ``norms_max[ti] * norms_max[tj]`` bound every
tile pair's entries, so pairs are scanned in descending bound order until
the bound falls below the running maximum (``select.grid.tiles_scanned`` vs
``select.grid.tiles_pruned``).  Host numpy only, so the stream and engine
layers import it without cycles.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instrument import bump

__all__ = [
    "normalize_lambda_grid",
    "lambda_max",
    "lambda_max_from_data",
    "lambda_grid",
]


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


def lambda_max_from_data(X, *, config=None) -> float:
    """Exact lambda_max straight from the (n, p) data matrix — no dense S.

    One moments pass (``stream.tiler.column_moments``) yields the per-column
    sqrt(S_ii); tile pairs are then visited in DESCENDING Cauchy-Schwarz
    bound order and the scan stops as soon as the next bound cannot beat the
    running maximum.  Each visited pair computes its centered Gram block in
    row chunks (the screener's accumulation idiom), so peak memory stays
    O(n * tile + tile^2)."""
    from repro_torch.stream.config import as_config
    from repro_torch.stream.tiler import column_moments, tile_maxima

    X = np.asarray(X)
    n, p = X.shape
    cfg = as_config(config)
    moments = column_moments(X, chunk=cfg.chunk)
    norms_max = tile_maxima(moments.norms, cfg.tile)
    ti, tj = np.triu_indices(norms_max.shape[0])
    bound = norms_max[ti] * norms_max[tj]
    order = np.argsort(-bound, kind="stable")

    best = 0.0
    scanned = 0
    for k in order:
        if bound[k] <= best:
            break
        i, j = int(ti[k]), int(tj[k])
        ci = slice(i * cfg.tile, min((i + 1) * cfg.tile, p))
        cj = slice(j * cfg.tile, min((j + 1) * cfg.tile, p))
        blk = np.zeros((ci.stop - ci.start, cj.stop - cj.start))
        for r0 in range(0, n, cfg.chunk):
            rows = X[r0 : r0 + cfg.chunk].astype(np.float64, copy=False)
            blk += (rows[:, ci] - moments.mu[ci]).T @ (rows[:, cj] - moments.mu[cj])
        blk = np.abs(blk) / n
        if i == j:
            np.fill_diagonal(blk, 0.0)
        best = max(best, float(blk.max(initial=0.0)))
        scanned += 1
    bump("select.grid.tiles_scanned", scanned)
    bump("select.grid.tiles_pruned", int(ti.size - scanned))
    return best


def lambda_grid(
    S=None,
    *,
    X=None,
    n_points: int = 20,
    scale: str = "log",
    lam_min_ratio: float = 0.1,
    config=None,
) -> list[float]:
    """The auto grid: ``n_points`` values from lambda_max down to
    ``lam_min_ratio * lambda_max``, log-spaced by default.

    Pass the dense covariance ``S`` OR the raw data matrix ``X`` (anchored
    via ``lambda_max_from_data`` — S is never formed).  The top grid point
    sits exactly at lambda_max, where the strict threshold screens every
    vertex isolated — the all-singleton end of the path."""
    if (S is None) == (X is None):
        raise ValueError("lambda_grid needs exactly one of S or X=")
    if n_points < 1:
        raise ValueError(f"n_points must be >= 1, got {n_points}")
    if not 0.0 < lam_min_ratio <= 1.0:
        raise ValueError(f"lam_min_ratio must be in (0, 1], got {lam_min_ratio}")
    anchor = lambda_max(S) if S is not None else lambda_max_from_data(X, config=config)
    if anchor <= 0.0:
        raise ValueError(
            "lambda_max is 0 — no off-diagonal covariance signal to grid over"
        )
    if scale == "log":
        grid = np.geomspace(anchor, anchor * lam_min_ratio, n_points)
    elif scale == "linear":
        grid = np.linspace(anchor, anchor * lam_min_ratio, n_points)
    else:
        raise ValueError(f"scale must be 'log' or 'linear', got {scale!r}")
    return normalize_lambda_grid(grid)
