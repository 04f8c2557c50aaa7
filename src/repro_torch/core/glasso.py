"""Public graphical-lasso API: a thin wrapper over the Plan->Execute engine.

``glasso(S, lam)`` solves (1) with exact covariance-thresholding screening
(Theorem 1) on by default, or ``screen=False`` for the paper's "without
screening" baseline.  Configuration travels as one typed value,
``options=EngineOptions(...)``; the solve runs on ``options.device``
(``"cuda"`` unless the caller passes ``device="cpu"``).

``glasso_path`` and solving from the data matrix (``X=`` /
``from_data=True``) raise ``NotImplementedError`` until their slices land.
"""

from __future__ import annotations

import numpy as np

from repro_torch.engine.api import Engine, GlassoResult
from repro_torch.engine.options import EngineOptions, normalize_options

__all__ = ["GlassoResult", "EngineOptions", "glasso", "glasso_path"]


def glasso(
    S: np.ndarray | None = None,
    lam: float | None = None,
    *,
    X: np.ndarray | None = None,
    from_data: bool = False,
    stream=None,
    screen: bool = True,
    p_max: int | None = None,
    warm_W: np.ndarray | None = None,
    options: EngineOptions | None = None,
    **engine_kwargs,
) -> GlassoResult:
    """Solve the graphical lasso at one lambda; returns a ``GlassoResult``
    whose ``Theta`` is a dense (p, p) numpy array."""
    if from_data or X is not None or stream is not None:
        raise NotImplementedError("solving from the data matrix is not ported yet (slice 6)")
    opts = normalize_options(options, engine_kwargs, warn=True, context="glasso")
    if S is None or lam is None:
        raise ValueError("glasso needs (S, lam)")
    return Engine(options=opts).run(S, lam, screen=screen, p_max=p_max, warm_W=warm_W)


def glasso_path(S=None, lambdas=None, **_kwargs):
    """The descending-lambda path (Theorem 2) is not ported yet."""
    raise NotImplementedError("glasso_path is not ported yet (slice 2)")
