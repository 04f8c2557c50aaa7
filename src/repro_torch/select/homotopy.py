"""The homotopy path executor: largest lambda down, warm all the way.

Thin wrapper over ``Engine.run_path`` / ``run_path_from_data`` — the engine
already plans the whole descending grid from one union-find pass (Theorem
2) and warm-starts every bucket: unchanged buckets resume from their own
previous padded solutions on device, and merged components start from the
block-diagonal stack of their children's Thetas (``blockwise_inverse`` /
``SparseTheta.gather_block``, whose cross-component entries are exact
zeros by Theorem 1 — a valid PD iterate).  What this module adds is the
ACCOUNTING: ``Engine._execute_path`` bumps, per solver-bound bucket,

    select.warm.reused   warm-started from its own previous solution
    select.warm.merged   warm-started from the merged blockwise inverse
    select.warm.cold     no warm source (first grid point, warm_start=False,
                         a non-warm-capable solver, or a fresh sharded block)

and ``warm_counts()`` reads them back — the homotopy acceptance metric
(bench_select gates on the warm fraction) and the ``SelectionReport.warm``
field both come from these counters.  Buckets on closed-form/chordal routes
are solved directly either way and are never counted.
"""

from __future__ import annotations

from repro_torch.core.instrument import tail_counts
from repro_torch.engine.api import Engine, GlassoResult
from repro_torch.engine.options import EngineOptions
from repro_torch.select.grid import normalize_lambda_grid

__all__ = ["homotopy_path", "warm_counts"]


def homotopy_path(
    S=None,
    *,
    X=None,
    lambdas,
    options: EngineOptions | None = None,
    warm_start: bool = True,
    stream=None,
    p_max: int | None = None,
    output: str | None = None,
) -> list[GlassoResult]:
    """Solve a descending lambda grid with full warm-start reuse.

    Pass the dense covariance ``S`` or the raw data matrix ``X`` (screened
    out-of-core — the dense S never exists).  ``warm_start=False`` is the
    cold-restart baseline arm (identical planning, every solver-bound
    bucket starts from scratch) that bench_select measures against.
    Results are exactly ``glasso_path``'s — the selection layer is built on
    the public path contract, not beside it."""
    if (S is None) == (X is None):
        raise ValueError("homotopy_path needs exactly one of S or X=")
    lams = normalize_lambda_grid(lambdas)
    engine = Engine(options=options if options is not None else EngineOptions())
    if X is not None:
        return engine.run_path_from_data(
            X, lams, stream=stream, warm_start=warm_start, p_max=p_max,
            output=output,
        )
    return engine.run_path(
        S, lams, warm_start=warm_start, p_max=p_max, output=output
    )


def warm_counts() -> dict[str, int]:
    """The ``select.warm.*`` counters since the last ``instrument.reset``:
    {"reused": ..., "merged": ..., "cold": ...} (absent keys = 0 bumps)."""
    return tail_counts("select.warm.")
