"""StARS: Stability Approach to Regularization Selection (Liu et al., 2010).

For each of ``n_subsamples`` row subsamples of size b (default the paper's
b = floor(10 sqrt(n)), capped at n - 1), the whole lambda path runs through
the STREAMED screener (``Engine.run_path_from_data``) — one tiled pass over
the subsample per path, materialized per-component blocks, and never a
dense (p, p) S.  Per lambda, each edge's selection frequency xi_ij is the
fraction of subsamples whose estimated graph contains it, its instability
is 2 xi (1 - xi), and the total instability

    D(lam) = sum_{i<j} 2 xi_ij (1 - xi_ij) / (p choose 2)

is accumulated SPARSELY over the edges actually observed (an edge absent
from every subsample has xi = 0 and contributes nothing).  Because
components only merge as lambda drops (Theorem 2), instability is
monotonized along the descending grid (Dbar = running max) and StARS
selects the SMALLEST lambda with Dbar <= beta — the sparsest graph whose
support is reproducible under resampling.  Falls back to the largest
(most regularized) lambda when no grid point meets beta.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instrument import bump
from repro_torch.engine.api import Engine
from repro_torch.engine.options import EngineOptions
from repro_torch.select.grid import normalize_lambda_grid

__all__ = ["stars"]


def stars(
    X,
    lambdas,
    *,
    options: EngineOptions | None = None,
    stream=None,
    n_subsamples: int = 20,
    subsample_size: int | None = None,
    beta: float = 0.05,
    seed: int = 0,
) -> dict:
    """Run StARS over a descending grid; returns a dict with per-lambda
    ``scores`` (instability D), the monotonized ``monotone`` curve, the
    ``selected_index`` into the normalized descending grid, and the
    resampling parameters used."""
    X = np.asarray(X)
    n, p = X.shape
    lams = normalize_lambda_grid(lambdas)
    if n_subsamples < 2:
        raise ValueError(f"StARS needs >= 2 subsamples, got {n_subsamples}")
    if not 0.0 < beta < 1.0:
        raise ValueError(f"beta must be in (0, 1), got {beta}")
    b = subsample_size if subsample_size is not None else int(10.0 * np.sqrt(n))
    b = int(min(max(b, 2), n - 1)) if n > 2 else n
    rng = np.random.default_rng(seed)
    engine = Engine(options=options if options is not None else EngineOptions())

    # per-lambda lists of observed-edge keys (i * p + j), one array per
    # subsample — frequencies come from one np.unique at the end
    observed: list[list[np.ndarray]] = [[] for _ in lams]
    for _ in range(n_subsamples):
        rows = rng.choice(n, size=b, replace=False)
        results = engine.run_path_from_data(X[rows], lams, stream=stream)
        for li, res in enumerate(results):
            e = res.support_edges()
            if len(e):
                observed[li].append(e[:, 0].astype(np.int64) * p + e[:, 1])
        bump("select.stars.subsamples")

    denom = p * (p - 1) / 2.0
    scores = []
    for li in range(len(lams)):
        if observed[li]:
            _, counts = np.unique(np.concatenate(observed[li]), return_counts=True)
            xi = counts / float(n_subsamples)
            scores.append(float(np.sum(2.0 * xi * (1.0 - xi)) / denom))
        else:
            scores.append(0.0)
    monotone = np.maximum.accumulate(scores)  # descending grid: instability grows
    ok = np.flatnonzero(monotone <= beta)
    selected = int(ok[-1]) if ok.size else 0
    return {
        "scores": scores,
        "monotone": [float(v) for v in monotone],
        "selected_index": selected,
        "beta": float(beta),
        "n_subsamples": int(n_subsamples),
        "subsample_size": int(b),
    }
