"""K-fold cross-validated Gaussian log-likelihood over the lambda path.

Each fold's training rows run the full homotopy path through the streamed
screener (``Engine.run_path_from_data`` — no dense S), and every path
result is scored on the HELD-OUT rows per component:

    score_fold(lam) = logdet Theta_lam - tr(S_test Theta_lam)

where the test-covariance blocks are gathered through ``CovSource`` for
exactly the vertices of each estimated component (plus the isolated
closed-form diagonal terms) — the held-out trace is a sum of per-block
products, never a global dense one.  Fold scores are weighted by held-out
size and averaged; the SELECTED lambda maximizes the mean held-out
log-likelihood (argmax — the opposite sign convention from EBIC's argmin,
normalized by ``select_path`` into a single report).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instrument import bump
from repro_torch.engine.api import Engine
from repro_torch.engine.options import EngineOptions
from repro_torch.select.criteria import CovSource, loglik_terms
from repro_torch.select.grid import normalize_lambda_grid

__all__ = ["kfold_cv"]


def kfold_cv(
    X,
    lambdas,
    *,
    options: EngineOptions | None = None,
    stream=None,
    k: int = 5,
    seed: int = 0,
) -> dict:
    """Run k-fold CV over a descending grid; returns per-lambda mean
    held-out log-likelihood ``scores`` (higher is better), the argmax
    ``selected_index``, and the fold parameters."""
    X = np.asarray(X)
    n = X.shape[0]
    lams = normalize_lambda_grid(lambdas)
    if not 2 <= k <= n:
        raise ValueError(f"k must be in [2, n={n}], got {k}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    engine = Engine(options=options if options is not None else EngineOptions())

    scores = np.zeros(len(lams))
    for fi, test_rows in enumerate(folds):
        train_rows = np.concatenate(
            [f for fj, f in enumerate(folds) if fj != fi]
        )
        results = engine.run_path_from_data(X[train_rows], lams, stream=stream)
        held_out = CovSource(X=X[test_rows])
        for li, res in enumerate(results):
            ld, tr = loglik_terms(res, held_out)
            scores[li] += (ld - tr) * len(test_rows)
        bump("select.cv.folds")
    scores /= n
    return {
        "scores": [float(v) for v in scores],
        "selected_index": int(np.argmax(scores)),
        "k": int(k),
        "seed": int(seed),
    }
