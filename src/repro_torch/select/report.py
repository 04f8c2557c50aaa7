"""``select_path``: one warm homotopy path, one criterion, one report.

The front door of ``repro_torch.select``: resolve the grid (explicit list,
``{"auto": n}``, or a bare int — all anchored at lambda_max when auto),
run the warm-started homotopy path ONCE on the full data, score every grid
point with the requested criterion, and return a ``Selection``:

    selection.result    the criterion-selected GlassoResult
    selection.path      every per-lambda result, largest lambda first
    selection.report    SelectionReport — per-lambda score / support size /
                        component count / route mix / stage timings, the
                        selected index, and the warm-start accounting
                        (select.warm.* counter deltas for THIS path)

Criteria semantics: "ebic" minimizes (needs the sample count — implicit
from X, ``n=`` with a covariance input); "cv" and "stars" resample rows and
therefore REQUIRE the data matrix ``X`` (their extra paths run through the
streamed screener per subsample/fold; the reported path is still the
full-data one, so the selected graph is always estimated from all rows).

Every path (the full-data one, each CV fold's, each StARS subsample's)
runs on ``options.device``: the card unless the options say ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.instrument import tail_counts
from repro_torch.engine.api import GlassoResult
from repro_torch.engine.options import EngineOptions
from repro_torch.obs.trace import span, trace_request
from repro_torch.select.criteria import CovSource, ebic_score
from repro_torch.select.grid import lambda_grid, normalize_lambda_grid
from repro_torch.select.homotopy import homotopy_path

__all__ = ["CRITERIA", "SelectionReport", "Selection", "select_path"]

#: Criteria ``select_path`` accepts.
CRITERIA = ("ebic", "cv", "stars")


@dataclass
class SelectionReport:
    """Per-lambda diagnostics + the selection decision for one path."""

    criterion: str
    lambdas: list[float]                 # descending, normalized
    scores: list[float]                  # criterion value per lambda
    selected_index: int
    support_sizes: list[int] = field(default_factory=list)
    n_components: list[int] = field(default_factory=list)
    route_mixes: list[dict] = field(default_factory=list)
    stages_us: list[dict] = field(default_factory=list)
    warm: dict = field(default_factory=dict)   # select.warm.* deltas
    detail: dict = field(default_factory=dict)  # criterion parameters

    @property
    def selected_lam(self) -> float:
        return self.lambdas[self.selected_index]

    @property
    def warm_fraction(self) -> float:
        """Warm-started share of this path's solver-bound buckets (reused +
        merged over all counted solves); 0.0 when nothing needed a solver."""
        total = sum(self.warm.values())
        if not total:
            return 0.0
        return (self.warm.get("reused", 0) + self.warm.get("merged", 0)) / total


@dataclass
class Selection:
    """What ``select_path`` returns: the selected result, the full path, and
    the report."""

    result: GlassoResult
    report: SelectionReport
    path: list[GlassoResult]


def _resolve_grid(grid, S, X, stream) -> list[float]:
    if grid is None:
        grid = {"auto": 20}
    if isinstance(grid, (int, np.integer)):
        grid = {"auto": int(grid)}
    if isinstance(grid, dict):
        if set(grid) != {"auto"}:
            raise ValueError(
                f"grid dict must be exactly {{'auto': n_points}}, got {grid!r}"
            )
        return lambda_grid(S, X=X, n_points=int(grid["auto"]), config=stream)
    return normalize_lambda_grid(grid)


def select_path(
    S=None,
    *,
    X=None,
    grid=None,
    criterion: str = "ebic",
    n: int | None = None,
    gamma: float = 0.5,
    options: EngineOptions | None = None,
    stream=None,
    output: str | None = None,
    criterion_opts=None,
) -> Selection:
    """Pick the best lambda on a descending grid; see the module docstring.

    ``grid`` is an explicit sequence, ``{"auto": n_points}``, a bare int
    (same as auto), or None (auto, 20 points); ``criterion_opts`` forwards
    criterion-specific knobs (cv: ``k``/``seed``; stars: ``n_subsamples``/
    ``subsample_size``/``beta``/``seed``; ebic: ``gamma`` overriding the
    kwarg)."""
    if (S is None) == (X is None):
        raise ValueError("select_path needs exactly one of S or X=")
    if criterion not in CRITERIA:
        raise ValueError(
            f"criterion must be one of {CRITERIA}, got {criterion!r}"
        )
    from contextlib import nullcontext

    copts = dict(criterion_opts or {})
    trace_ctx = (
        trace_request("select.path", criterion=criterion)
        if (options is None or options.trace)
        else nullcontext()
    )
    with trace_ctx:
        with span("select.grid"):
            lams = _resolve_grid(grid, S, X, stream)

        warm_before = tail_counts("select.warm.")
        results = homotopy_path(
            S, X=X, lambdas=lams, options=options, stream=stream,
            output=output,
        )
        warm = {
            k: v - warm_before.get(k, 0)
            for k, v in tail_counts("select.warm.").items()
            if v - warm_before.get(k, 0)
        }

        detail: dict = {}
        with span("select.score", criterion=criterion):
            if criterion == "ebic":
                n_obs = int(np.asarray(X).shape[0]) if X is not None else n
                if n_obs is None:
                    raise ValueError(
                        "EBIC needs the sample count: pass n= with a "
                        "covariance input"
                    )
                g = float(copts.pop("gamma", gamma))
                if copts:
                    raise TypeError(
                        f"unknown EBIC criterion_opts: {sorted(copts)}"
                    )
                src = CovSource(S=S) if S is not None else CovSource(X=X)
                scores = [ebic_score(r, src, n_obs, gamma=g) for r in results]
                selected = int(np.argmin(scores))
                detail = {"gamma": g, "n": int(n_obs)}
            elif criterion == "cv":
                if X is None:
                    raise ValueError(
                        "criterion 'cv' resamples rows and needs X="
                    )
                from repro_torch.select.cv import kfold_cv

                out = kfold_cv(X, lams, options=options, stream=stream, **copts)
                scores, selected = out["scores"], out["selected_index"]
                detail = {
                    k: v for k, v in out.items()
                    if k not in ("scores", "selected_index")
                }
            else:  # stars
                if X is None:
                    raise ValueError(
                        "criterion 'stars' resamples rows and needs X="
                    )
                from repro_torch.select.stability import stars

                out = stars(X, lams, options=options, stream=stream, **copts)
                scores, selected = out["scores"], out["selected_index"]
                detail = {
                    k: v for k, v in out.items()
                    if k not in ("scores", "selected_index")
                }

    report = SelectionReport(
        criterion=criterion,
        lambdas=[r.lam for r in results],
        scores=[float(v) for v in scores],
        selected_index=selected,
        support_sizes=[int(r.support_edges().shape[0]) for r in results],
        n_components=[
            int(r.screen.n_components) if r.screen is not None else 0
            for r in results
        ],
        route_mixes=[dict(r.route_mix) for r in results],
        stages_us=[r.stages_us for r in results],
        warm=warm,
        detail=detail,
    )
    return Selection(result=results[selected], report=report, path=results)
