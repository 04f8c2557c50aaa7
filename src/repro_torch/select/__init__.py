"""Model selection over lambda grids: the path, scored and decided.

Screening makes a whole descending grid nearly free (components only merge
as lambda drops, Theorem 2), so the question becomes "which lambda?":

    grid        normalize_lambda_grid (THE grid chokepoint shared with
                glasso_path / run_path / stream_screen), lambda_max (and
                the exact streamed variant), lambda_grid
    homotopy    warm-started path execution + select.warm.* accounting
    criteria    per-component Gaussian loglik + EBIC (CovSource blocks)
    stability   StARS over streamed subsample paths
    cv          k-fold held-out log-likelihood
    report      select_path -> Selection(result, report, path)

Every path runs through ``Engine.run_path`` / ``run_path_from_data`` on the
engine's device (the card by default); the scoring is host numpy over the
per-component blocks.
"""

from repro_torch.select.criteria import (
    CovSource,
    ebic_score,
    gaussian_loglik,
    loglik_terms,
)
from repro_torch.select.cv import kfold_cv
from repro_torch.select.grid import (
    lambda_grid,
    lambda_max,
    lambda_max_from_data,
    normalize_lambda_grid,
)
from repro_torch.select.homotopy import homotopy_path, warm_counts
from repro_torch.select.report import CRITERIA, Selection, SelectionReport, select_path
from repro_torch.select.stability import stars

__all__ = [
    "CRITERIA",
    "CovSource",
    "Selection",
    "SelectionReport",
    "ebic_score",
    "gaussian_loglik",
    "homotopy_path",
    "kfold_cv",
    "lambda_grid",
    "lambda_max",
    "lambda_max_from_data",
    "loglik_terms",
    "normalize_lambda_grid",
    "select_path",
    "stars",
    "warm_counts",
]
