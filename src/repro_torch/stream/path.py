"""Path adapter: a whole descending-lambda plan straight from X.

``plan_path_streaming`` is the streamed twin of ``engine.planner.plan_path``:
one ``stream_screen`` call (one ``covgram_screen`` pass over the tile pairs
at the grid's smallest lambda) replaces the dense sort and union-find, then
every lambda's plan is built by the same ``build_plan_incremental`` — with
``S`` the materialized per-component blocks — so bucket reuse by (padded
size, structure, membership) key and structure routing work unchanged
against streamed edge weights.  The executor consumes the resulting
``PathPlan`` exactly as a dense one.
"""

from __future__ import annotations

import numpy as np

from repro_torch.engine.planner import (
    PathPlan,
    PathStep,
    build_plan_incremental,
    component_lifetimes,
)
from repro_torch.stream.screen import StreamScreen, stream_screen


def plan_path_from_screen(
    sc: StreamScreen,
    *,
    dtype=np.float64,
    classify_structures: bool = True,
    oversize: int | None = None,
) -> PathPlan:
    """Build the per-lambda plans over an existing streamed screen."""
    if sc.S is None:
        raise ValueError(
            "plan_path_from_screen needs a materialized screen "
            "(stream_screen(..., materialize=True))"
        )
    life = component_lifetimes(sc.labels)
    path = PathPlan(p=sc.p, lambdas=list(sc.lambdas))
    prev_plan = None
    for lam, labels, stats in zip(sc.lambdas, sc.labels, sc.stats):
        plan, reused = build_plan_incremental(
            sc.S, lam, labels, prev=prev_plan, dtype=dtype,
            classify_structures=classify_structures, oversize=oversize,
            lifetime_of=life,
        )
        path.steps.append(
            PathStep(lam=lam, labels=labels, plan=plan, screen=stats, reused_keys=reused)
        )
        prev_plan = plan
    return path


def plan_path_streaming(
    X: np.ndarray,
    lambdas,
    *,
    config=None,
    dtype=np.float64,
    classify_structures: bool = True,
    oversize: int | None = None,
    device="cuda",
) -> tuple[PathPlan, StreamScreen]:
    """Screen X out of core at every lambda on ``device`` and plan the whole
    path.

    Returns (path, screen): the screen carries the streamed edges, moments
    and counters.  ``oversize`` (the single-device block cap) defers giant
    components to the sharded route: no host block, a shard-direct gather
    at solve time."""
    sc = stream_screen(X, lambdas, config=config, device=device, oversize=oversize)
    return (
        plan_path_from_screen(
            sc, dtype=dtype, classify_structures=classify_structures, oversize=oversize,
        ),
        sc,
    )
