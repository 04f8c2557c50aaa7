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

``glasso_path(S, lams)`` solves a descending lambda path exploiting
Theorem 2: the engine plans the whole grid from ONE union-find pass, diffs
consecutive plans so unchanged buckets keep their device stacks, and
warm-starts every iterative block from the previous solution (a reused
bucket from its own, on the device).  ``glasso_path(X=X, lambdas=lams,
from_data=True)`` plans the grid from one streamed screen of X.
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


def glasso_path(
    S: np.ndarray | None = None,
    lambdas=None,
    *,
    X: np.ndarray | None = None,
    from_data: bool = False,
    stream=None,
    warm_start: bool = True,
    screen: bool = True,
    p_max: int | None = None,
    options: EngineOptions | None = None,
    **engine_kwargs,
) -> list[GlassoResult]:
    """Solve along a descending lambda path (one planning pass, warm starts);
    returns one ``GlassoResult`` per distinct lambda, largest first.

    ``options.cc_backend`` is accepted for symmetry with ``glasso``; path
    planning always uses the host edge-sorted union-find (it IS the
    incremental planner), which gives the identical partition.
    ``screen=False`` is the paper's unscreened baseline: no planner, one
    dense solve per lambda.  ``warm_start=False`` plans identically but
    starts every solver-bound bucket cold.  From data (``X=`` or
    ``from_data=True``), ONE streamed screen of X covers the whole grid
    (the edges above the grid minimum determine every partition), with the
    same diffed plans and warm starts and no (p, p) allocation in the
    screening stage."""
    opts = normalize_options(options, engine_kwargs, warn=True, context="glasso_path")
    engine = Engine(options=opts)
    data = X if X is not None else (S if from_data else None)
    if from_data or X is not None:
        if data is None:
            raise ValueError("from_data=True needs the data matrix (X=...)")
        if X is not None and S is not None:
            raise ValueError("pass either S or X=, not both")
        if lambdas is None:
            raise ValueError("glasso_path needs lambdas")
        return engine.run_path_from_data(
            data, lambdas, stream=stream, warm_start=warm_start, p_max=p_max
        )
    if S is None or lambdas is None:
        raise ValueError("glasso_path needs (S, lambdas) — or X=/from_data=True")
    if not screen:
        from repro_torch.select.grid import normalize_lambda_grid

        lams = normalize_lambda_grid(lambdas)
        return [engine.run(S, lam, screen=False, p_max=p_max) for lam in lams]
    return engine.run_path(S, lambdas, warm_start=warm_start, p_max=p_max)
