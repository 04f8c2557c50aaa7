"""Public graphical-lasso API: a thin wrapper over the Plan->Execute engine.

``glasso(S, lam)`` solves (1) with exact covariance-thresholding screening
(Theorem 1) on by default, or ``screen=False`` for the paper's "without
screening" baseline.  Configuration travels as one typed value,
``options=EngineOptions(...)``; the solve runs on ``options.device``
(``"cuda"`` unless the caller passes ``device="cpu"``).

``glasso(X=X, lam=lam, from_data=True)`` solves from the (n, p) DATA
matrix instead: screening runs out of core through ``repro_torch.stream``
(the ``covgram_screen`` kernel on the card; the dense (p, p) S is never
built, only the per-component blocks the solvers consume), exactness
unchanged.  ``stream`` passes a ``StreamConfig`` (or kwargs dict) for the
call, overriding ``options.stream``; ``screen``/``cc_backend`` do not apply
there (the streamed screen IS the screening stage).

``glasso_path`` raises ``NotImplementedError`` until its slice lands.
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
    whose ``Theta`` is a dense (p, p) numpy array, or a ``SparseTheta``
    when ``options.output`` resolves to "sparse" (the default "auto" does
    above ``AUTO_SPARSE_P`` = 8192)."""
    opts = normalize_options(options, engine_kwargs, warn=True, context="glasso")
    engine = Engine(options=opts)
    data = X if X is not None else (S if from_data else None)
    if from_data or X is not None:
        if data is None:
            raise ValueError("from_data=True needs the data matrix (X=...)")
        if X is not None and S is not None:
            raise ValueError("pass either S or X=, not both")
        if lam is None:
            raise ValueError("glasso needs lam")
        return engine.run_from_data(
            data, lam, stream=stream, p_max=p_max, warm_W=warm_W
        )
    if S is None or lam is None:
        raise ValueError("glasso needs (S, lam) — or X=/from_data=True")
    return engine.run(S, lam, screen=screen, p_max=p_max, warm_W=warm_W)


def glasso_path(S=None, lambdas=None, **_kwargs):
    """The descending-lambda path (Theorem 2) is not ported yet."""
    raise NotImplementedError("glasso_path is not ported yet (slice 2)")
