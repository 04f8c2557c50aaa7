"""The Plan->Execute engine: one object owning the whole pipeline

    screen -> partition -> bucket -> solve -> assemble

``Engine.run`` is one (S, lam) solve through a registry screening backend,
the bucket planner and the executor, on the device ``EngineOptions.device``
names (``"cuda"`` by default); ``Engine.run_from_data`` screens straight
from the (n, p) data matrix through ``repro_torch.stream`` and solves over
the materialized component blocks.  ``Engine.run_path`` and
``run_path_from_data`` solve a descending lambda grid with ONE partition
pass (``planner.plan_path``, or one streamed screen), diffed plans and warm
starts between consecutive lambdas.  ``repro_torch.glasso`` and
``glasso_path`` are thin wrappers over them.  Inputs and results are numpy
arrays, as in the reference package: a dense (p, p) Theta, or, when
``output`` resolves to "sparse" (``"auto"`` above ``AUTO_SPARSE_P``), a
``SparseTheta`` built on the executor's solution stacks with no (p, p)
allocation.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from repro_torch.core import schedule as schedule_mod
from repro_torch.core.components import component_lists
from repro_torch.core.distributed import as_mesh, local_device_mesh
from repro_torch.core.instrument import bump
from repro_torch.core.screening import (
    ScreenStats,
    screen_stats_from_labels,
    thresholded_components,
)
from repro_torch.core.sparse import SparseTheta, resolve_output, result_nbytes
from repro_torch.engine.executor import BucketExecutor
from repro_torch.engine.options import EngineOptions, normalize_options
from repro_torch.engine.planner import build_plan_incremental, plan_path
from repro_torch.obs.trace import Trace, current_trace, span, trace_request


def _as_cov_operand(S):
    """Dense arrays pass through np.asarray; materialized streamed
    covariances (the gather protocol: ``gather_block``/``diag_at``) are used
    as-is — wrapping them in an object array would defeat the point."""
    return S if hasattr(S, "gather_block") else np.asarray(S)


class GlassoResult:
    """One solve's answer + attribution.

    ``Theta`` is the dense (p, p) numpy precision matrix, or a
    ``SparseTheta`` when the output resolved to "sparse" (``output`` says
    which); ``labels`` the canonical screening partition; ``route_mix`` the
    number of blocks per structure class; ``oversize`` the sharded route's
    accounting ({dispatched, inner_iters, fallbacks}, empty when no block
    took it); ``bytes_peak`` the resident bytes of Theta as assembled.
    Timing lives in the ``stages()`` view (seconds per canonical stage) and
    the ``*_seconds`` properties over it; ``trace`` carries the request's
    span tree when the solve ran traced."""

    def __init__(
        self,
        lam: float,
        Theta,
        labels: np.ndarray,
        screen: ScreenStats | None,
        solve_seconds: float,
        solver: str,
        route_mix: dict | None = None,
        routed: bool = True,
        assemble_seconds: float = 0.0,
        dispatch_seconds: float = 0.0,
        device: str = "cpu",
        trace: Trace | None = None,
        oversize: dict | None = None,
        block_sizes: list[int] | None = None,
        bytes_peak: int = 0,
        output: str = "dense",
    ):
        self.lam = lam
        self.Theta = Theta
        self.labels = labels
        self.screen = screen
        self.solver = solver
        self.route_mix = dict(route_mix) if route_mix is not None else {}
        self.routed = routed
        self.device = device
        self.trace = trace
        # oversize-route accounting of this solve: {dispatched, inner_iters,
        # fallbacks}, empty when no block took the route; the process-wide
        # view is instrument counts("solver.oversize.")
        self.oversize = dict(oversize) if oversize is not None else {}
        self.block_sizes = list(block_sizes) if block_sizes is not None else []
        self.bytes_peak = int(bytes_peak)
        self.output = output
        self._stage_seconds = {
            "screen": float(screen.seconds) if screen is not None else 0.0,
            "solve": float(solve_seconds),
            "dispatch": float(dispatch_seconds),
            "assemble": float(assemble_seconds),
        }

    def __repr__(self) -> str:
        return (
            f"GlassoResult(lam={self.lam!r}, p={len(self.labels)}, "
            f"solver={self.solver!r}, output={self.output!r}, device={self.device!r})"
        )

    def stages(self) -> dict[str, float]:
        """Seconds per canonical stage: ``screen`` / ``solve`` (device solve
        and verification, dispatch and assembly excluded) / ``dispatch``
        (host time issuing launches) / ``assemble``."""
        return dict(self._stage_seconds)

    @property
    def solve_seconds(self) -> float:
        return self._stage_seconds["solve"]

    @property
    def assemble_seconds(self) -> float:
        return self._stage_seconds["assemble"]

    @property
    def dispatch_seconds(self) -> float:
        return self._stage_seconds["dispatch"]

    @property
    def stages_us(self) -> dict[str, int]:
        """The ``stages()`` view in whole microseconds (``screen_us`` /
        ``solve_us`` / ``dispatch_us`` / ``assemble_us``): what
        ``SelectionReport.stages_us`` carries per grid point."""
        return {f"{k}_us": int(v * 1e6) for k, v in self._stage_seconds.items()}

    @property
    def screen_seconds(self) -> float:
        """Screening-stage seconds (0.0 when screening was skipped or the
        labels were precomputed)."""
        return self._stage_seconds["screen"]

    @property
    def support(self):
        """Estimated concentration-graph adjacency (eq. (2)).  A sparse
        result derives it from per-block nonzeros (dense bool up to the
        densify cap, scipy bool CSR above it), never from a (p, p) Theta."""
        if isinstance(self.Theta, SparseTheta):
            return self.Theta.support()
        A = np.abs(self.Theta) > 0
        np.fill_diagonal(A, False)
        return A

    def support_edges(self) -> np.ndarray:
        """(E, 2) off-diagonal upper-triangular support edges."""
        if isinstance(self.Theta, SparseTheta):
            return self.Theta.support_edges()
        r, c = np.nonzero(np.triu(self.support, k=1))
        return np.stack([r, c], axis=1).astype(np.int64) if r.size else np.zeros(
            (0, 2), dtype=np.int64
        )

    @property
    def noniterative_fraction(self) -> float:
        """Share of this solve's blocks ROUTED to a non-iterative solver
        (singletons included); 0.0 when the solve ran with route=False.
        KKT-rejected blocks repaired by the iterative tail are not
        subtracted — the ``router.fallback.*`` counters track those."""
        from repro_torch.engine.registry import route_for

        if not self.routed:
            return 0.0
        total = sum(self.route_mix.values())
        if not total:
            return 1.0
        iterative = sum(
            n for cls, n in self.route_mix.items()
            if route_for(cls) in ("iterative", "fused")
        )
        return 1.0 - iterative / total


def resolve_oversize(
    threshold: int | None, budget_mb: float | str | None, np_dtype, *,
    route: bool = True, device="cpu", devices=None,
) -> int | None:
    """Resolve the single-device block-size cap for the oversize route.

    An explicit ``threshold`` wins; otherwise it is derived from a per-device
    memory budget in MB (``blocks.oversize_threshold``), where ``"auto"``
    reads the memory of ``device``, or the least over the mesh ``devices``
    where one is given (``distributed.device_memory_budget_mb`` — None on
    the CPU, disabling the route).  Returns None when oversize
    routing is off.  Oversize is a ROUTE, so it requires the routing
    ladder."""
    if threshold is None and budget_mb is None:
        return None
    if not route:
        raise ValueError(
            "oversize_threshold / oversize_budget_mb require route=True "
            "(the oversize class is a routing-ladder rung)"
        )
    if threshold is not None:
        return int(threshold)
    if budget_mb == "auto":
        from repro_torch.core.distributed import device_memory_budget_mb

        budgets = [device_memory_budget_mb(d) for d in (devices or [device])]
        if None in budgets:
            return None
        budget_mb = min(budgets)
    from repro_torch.core.blocks import oversize_threshold as _threshold_from_budget

    return _threshold_from_budget(float(budget_mb), np_dtype)


def blockwise_inverse(
    labels: np.ndarray, Theta, needed: np.ndarray | None = None
):
    """W = inv(Theta) computed block by block over ``labels``' components
    (Theta is block-diagonal over them by Theorem 1).

    ``needed`` (bool mask over vertices) restricts the work to components
    that intersect it.  A dense Theta gives a dense W; a ``SparseTheta``
    gives a block-sparse W over the same components (inverses per block,
    reciprocal isolated diagonal), with no (p, p) buffer anywhere."""
    if isinstance(Theta, SparseTheta):
        return _blockwise_inverse_sparse(Theta, needed)
    W = np.zeros_like(Theta)
    for comp in component_lists(labels):
        if needed is not None and not needed[comp].any():
            continue
        W[np.ix_(comp, comp)] = np.linalg.inv(Theta[np.ix_(comp, comp)])
    return W


def _blockwise_inverse_sparse(
    Theta: SparseTheta, needed: np.ndarray | None
) -> SparseTheta:
    """Block-diagonal W = inv(Theta) of a sparse result, as another
    ``SparseTheta`` (one single-row stack per needed component)."""
    from repro_torch.core.sparse import _build_index

    stacks: list[np.ndarray] = []
    comps: list[np.ndarray] = []
    loc: list[tuple[int, int]] = []
    for c, blk in Theta.blocks():
        if needed is not None and not needed[c].any():
            continue
        comps.append(c)
        loc.append((len(stacks), 0))
        stacks.append(np.linalg.inv(blk)[None])
    iso = Theta.isolated
    vals = Theta.isolated_values
    if needed is not None and iso.size:
        keep = needed[iso]
        iso, vals = iso[keep], vals[keep]
    comp_id, pos_in = _build_index(Theta.p, comps, iso)
    return SparseTheta(
        Theta.p, Theta.dtype, stacks, comps, loc, comp_id, pos_in,
        iso, (1.0 / vals).astype(Theta.dtype, copy=False),
        densify_max=Theta.densify_max,
    )


def _result(
    plan, labels, screen_stats, Theta, seconds, solver, lam, *,
    routed: bool, assemble_seconds: float, dispatch_seconds: float, device: str,
    oversize: dict | None = None,
) -> GlassoResult:
    route_mix = {"singleton": len(plan.isolated)} if len(plan.isolated) else {}
    for b in plan.buckets:
        route_mix[b.structure] = route_mix.get(b.structure, 0) + len(b.comps)
    solve_seconds = max(0.0, seconds - assemble_seconds - dispatch_seconds)
    bump("engine.solve_us", int(solve_seconds * 1e6))
    if screen_stats is not None:
        bump("engine.screen_us", int(float(screen_stats.seconds) * 1e6))
    return GlassoResult(
        trace=current_trace(),
        lam=float(lam),
        Theta=Theta,
        labels=labels,
        screen=screen_stats,
        solve_seconds=solve_seconds,
        solver=solver,
        route_mix=route_mix,
        routed=routed,
        assemble_seconds=assemble_seconds,
        dispatch_seconds=dispatch_seconds,
        device=device,
        oversize=oversize,
        block_sizes=sorted(
            (len(c) for b in plan.buckets for c in b.comps), reverse=True
        ),
        bytes_peak=result_nbytes(Theta),
        output="sparse" if isinstance(Theta, SparseTheta) else "dense",
    )


class Engine:
    """Reusable pipeline instance: fixed (solver, dtype, device, cc_backend,
    options)."""

    def __init__(
        self,
        *,
        options: EngineOptions | None = None,
        devices=None,
        **legacy_engine_kwargs,
    ):
        """``options=EngineOptions(...)`` is the configuration surface.
        ``devices`` is the mesh (``core.distributed.DeviceMesh``, or a
        list of devices) the executor places buckets on and the oversize
        route and the ``"shard_map"`` screen span: d CUDA or CPU devices,
        repeats allowed (d logical shards on one device); None is every
        visible card when the engine's device is ``"cuda"``, the one
        device otherwise (``local_device_mesh``).  The ``"auto"`` oversize
        budget reads the least of the mesh's devices."""
        from repro_torch.core.solvers import WARM_START_SOLVERS, solver_spec

        opts = normalize_options(options, legacy_engine_kwargs, context="Engine")
        if opts.trace == "jax":
            raise NotImplementedError("trace='jax' annotates JAX profiles; use trace=True")
        self.options = opts
        self.output = opts.output
        self.solver = opts.resolved_solver("bcd")
        self.dtype = opts.resolved_dtype()
        self.np_dtype = opts.np_dtype()
        self.device = opts.resolved_device()
        self.devices = (
            local_device_mesh(self.device) if devices is None else as_mesh(devices)
        )
        self.oversize = resolve_oversize(
            opts.oversize_threshold, opts.oversize_budget_mb, self.np_dtype,
            route=opts.route, device=self.device, devices=self.devices,
        )
        self.cc_backend = opts.cc_backend
        self.stream = opts.stream   # default StreamConfig for from-data runs
        self.warm_capable = self.solver in WARM_START_SOLVERS
        # the wave packer (EngineOptions.fused): True demands the capability,
        # "auto" turns it on only for solvers that force it ("fused_bcd");
        # buckets ROUTED "fused" (registry.set_route) fuse regardless
        meta = solver_spec(self.solver).meta
        if opts.fused is True and not meta.get("fused_stack"):
            raise ValueError(
                f"fused=True requires a solver with the 'fused_stack' "
                f"capability; {self.solver!r} lacks it"
            )
        fused = (
            bool(meta.get("force_fused")) if opts.fused == "auto"
            else bool(opts.fused)
        )
        self.executor = BucketExecutor(
            solver=self.solver,
            dtype=self.dtype,
            device=self.device,
            solver_opts=dict(opts.solver_opts),
            route=opts.route,
            route_check_tol=opts.route_check_tol,
            fused=fused,
            devices=self.devices,
        )

    def _trace_ctx(self, name: str, **attrs):
        """Root a request trace for this run (or join the ambient one);
        ``EngineOptions(trace=False)`` makes the engine span-free."""
        if not self.options.trace:
            return nullcontext()
        return trace_request(name, **attrs)

    def screen(self, S: np.ndarray, lam: float) -> tuple[np.ndarray, ScreenStats]:
        with span("engine.screen", backend=self.cc_backend):
            return thresholded_components(
                S, lam, backend=self.cc_backend, **self._screen_opts()
            )

    def _screen_opts(self) -> dict:
        """The screening backend's device options: the engine's device, and
        for ``"shard_map"`` the engine's mesh."""
        if self.cc_backend == "shard_map":
            return {"device": self.device, "mesh": self.devices}
        return {"device": self.device}

    def run(
        self,
        S: np.ndarray,
        lam: float,
        *,
        screen: bool = True,
        p_max: int | None = None,
        warm_W: np.ndarray | None = None,
        labels: np.ndarray | None = None,
        screen_stats: ScreenStats | None = None,
        output: str | None = None,
    ) -> GlassoResult:
        """One solve.  ``screen=False`` is the paper's unscreened baseline
        (one global block); ``warm_W`` is a (p, p) covariance iterate whose
        restrictions warm-start the iterative buckets.  ``labels``
        short-circuits the screening stage with a precomputed canonical
        partition, and ``screen_stats`` rides along (the streaming
        screener's stats carry tile counters a dense recount would lose).
        ``S`` may be a materialized streamed covariance (gather protocol) —
        then ``labels`` is required, since dense screening needs dense S.
        ``output`` overrides ``options.output`` for this call."""
        S = _as_cov_operand(S)
        p = S.shape[0]
        with self._trace_ctx("engine.run", lam=float(lam), p=int(p)):
            screened = True
            if labels is not None:
                labels = np.asarray(labels)
                if screen_stats is None:
                    screen_stats = screen_stats_from_labels(S, lam, labels, seconds=0.0)
            elif hasattr(S, "gather_block"):
                raise ValueError(
                    "materialized covariances cannot be re-screened densely; "
                    "pass the streamed labels (see Engine.run_from_data)"
                )
            elif screen:
                labels, screen_stats = self.screen(S, lam)
            else:
                labels = np.zeros(p, dtype=np.int64)  # one global component
                screen_stats = None
                screened = False
            with span("engine.plan"):
                plan, _ = build_plan_incremental(
                    S, lam, labels, dtype=self.np_dtype,
                    classify_structures=self.executor.route and screened,
                    oversize=self.oversize if screened else None,
                )
            schedule_mod.check_capacity(
                [len(c) for b in plan.buckets for c in b.comps] or [1], p_max
            )
            out_mode = resolve_output(self.output if output is None else output, p)
            t0 = time.perf_counter()
            with span("engine.solve", lam=float(lam)):
                Theta = self.executor.solve_plan(
                    plan, float(lam), S, warm_W=warm_W, output=out_mode
                )
            seconds = time.perf_counter() - t0
            return _result(
                plan, labels, screen_stats, Theta, seconds, self.solver, lam,
                routed=self.executor.route,
                assemble_seconds=self.executor.last_assemble_seconds,
                dispatch_seconds=self.executor.last_dispatch_seconds,
                device=str(self.device),
                oversize=self.executor.last_oversize,
            )

    def run_path(
        self,
        S: np.ndarray,
        lambdas,
        *,
        warm_start: bool = True,
        p_max: int | None = None,
        output: str | None = None,
    ) -> list[GlassoResult]:
        """Descending path: one union-find pass, diffed plans, warm starts.

        Theorem 2 guarantees nested partitions, so (a) the planner snapshots
        every lambda from a single pass, and (b) the previous Theta
        restricted to a merged component is block-diagonal over its old
        sub-components — a valid PD warm start.  Buckets unchanged between
        consecutive lambdas keep their device stacks and warm-start from
        their own previous solutions on the device.  The path's partition
        is always the host union-find's (``cc_backend`` does not apply: the
        planner IS the partition pass, and gives the identical labels)."""
        S = _as_cov_operand(S)
        lambdas = list(lambdas)
        with self._trace_ctx("engine.path", n_lams=len(lambdas), p=int(S.shape[0])):
            with span("engine.plan"):
                path = plan_path(
                    S, lambdas, dtype=self.np_dtype,
                    classify_structures=self.executor.route,
                    oversize=self.oversize,
                )
            return self._execute_path(
                S, path, warm_start=warm_start, p_max=p_max, output=output
            )

    def _execute_path(
        self, S, path, *, warm_start: bool, p_max: int | None,
        output: str | None = None,
    ) -> list[GlassoResult]:
        """Run an already-planned path (dense or streamed) through the
        executor with bucket-level reuse and warm starts.

        Warm accounting (``select.warm.*``), one count per solver-bound
        bucket (iterative and sharded routes; closed-form and chordal
        blocks are solved directly either way): "reused" resumes from its
        own previous solution, "merged" is a fresh iterative bucket started
        from the previous result's blocks, "cold" has no warm source (the
        first grid point, ``warm_start=False``, a solver outside
        ``WARM_START_SOLVERS``, or a fresh sharded block)."""
        from repro_torch.engine.registry import route_for

        results: list[GlassoResult] = []
        prev: GlassoResult | None = None
        out_mode = resolve_output(self.output if output is None else output, S.shape[0])
        warmable = False
        for step in path.steps:
            schedule_mod.check_capacity(
                [len(c) for b in step.plan.buckets for c in b.comps] or [1], p_max
            )
            warm_Theta = None
            routes = [
                route_for(b.structure) if self.executor.route else "iterative"
                for b in step.plan.buckets
            ]
            if warmable and any(
                r in ("iterative", "fused") and not step.is_reused(b)
                for b, r in zip(step.plan.buckets, routes)
            ):
                # merged buckets gather their block-diagonal restriction of
                # the previous Theta (cross-component entries are exact
                # zeros) and the executor inverts the stacks on the device:
                # no dense (p, p) W is built on the host
                warm_Theta = prev.Theta
            for b, route in zip(step.plan.buckets, routes):
                if route not in ("iterative", "fused", "sharded"):
                    continue
                if warmable and step.is_reused(b):
                    bump("select.warm.reused")
                elif warmable and route in ("iterative", "fused"):
                    bump("select.warm.merged")
                else:
                    bump("select.warm.cold")
            t0 = time.perf_counter()
            with span("engine.solve", lam=float(step.lam)):
                Theta = self.executor.solve_plan(
                    step.plan, step.lam, S,
                    warm_Theta=warm_Theta,
                    reused_keys=step.reused_keys if warm_start else frozenset(),
                    keep_solutions=warm_start,
                    output=out_mode,
                )
            seconds = time.perf_counter() - t0
            prev = _result(
                step.plan, step.labels, step.screen, Theta, seconds, self.solver,
                step.lam, routed=self.executor.route,
                assemble_seconds=self.executor.last_assemble_seconds,
                dispatch_seconds=self.executor.last_dispatch_seconds,
                device=str(self.device),
                oversize=self.executor.last_oversize,
            )
            results.append(prev)
            warmable = warm_start and self.warm_capable
        return results

    def run_from_data(
        self,
        X: np.ndarray,
        lam: float,
        *,
        stream=None,
        p_max: int | None = None,
        warm_W: np.ndarray | None = None,
        output: str | None = None,
    ) -> GlassoResult:
        """One solve screened straight from the (n, p) data matrix.

        The dense S never exists: ``repro_torch.stream`` screens tile by
        tile on the engine's device (the ``covgram_screen`` kernel on the
        card), materializes only the per-component blocks, and the solve
        proceeds through the ordinary plan/execute stages (``stream`` takes
        a ``StreamConfig`` or kwargs dict, overriding ``options.stream``)."""
        from repro_torch.stream import stream_screen

        if stream is None:
            stream = self.stream
        p = int(np.shape(X)[1])
        with self._trace_ctx("engine.run", lam=float(lam), p=p, source="data"):
            with span("engine.screen", backend="stream"):
                sc = stream_screen(
                    X, [lam], config=stream, device=self.device, oversize=self.oversize
                )
            return self.run(
                sc.S,
                lam,
                labels=sc.labels[0],
                screen_stats=sc.stats[0],
                p_max=p_max,
                warm_W=warm_W,
                output=output,
            )

    def run_path_from_data(
        self,
        X: np.ndarray,
        lambdas,
        *,
        stream=None,
        warm_start: bool = True,
        p_max: int | None = None,
        output: str | None = None,
    ) -> list[GlassoResult]:
        """A descending lambda path screened straight from X: one streamed
        screen covers the whole grid (Theorem 2 — the compacted edges above
        the grid minimum determine every partition), then the diffed-plan
        execution of ``run_path`` runs over the materialized blocks."""
        from repro_torch.stream import plan_path_streaming

        if stream is None:
            stream = self.stream
        lambdas = list(lambdas)
        p = int(np.shape(X)[1])
        with self._trace_ctx("engine.path", n_lams=len(lambdas), p=p, source="data"):
            with span("engine.plan", backend="stream"):
                path, sc = plan_path_streaming(
                    X, lambdas, config=stream, dtype=self.np_dtype,
                    classify_structures=self.executor.route,
                    oversize=self.oversize, device=self.device,
                )
            return self._execute_path(
                sc.S, path, warm_start=warm_start, p_max=p_max, output=output
            )
