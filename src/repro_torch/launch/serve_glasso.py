"""Batched graphical-lasso serving: many concurrent (S, lam) requests, one
coalesced solver stream — the ROADMAP's "heavy traffic" workload for the
Theorem-1 pipeline.

Theorem 1 makes every request a bag of INDEPENDENT padded blocks, and the
engine's executor already batches same-size blocks; serving just widens the
batch axis across requests.  The batcher thread drains the queue, screens and
plans each request through the engine registry/planner, then regroups every
(request, bucket) by padded size and dispatches ONE kernel launch per size
with a per-block lambda vector — so requests with different lambdas, or
different matrices, share launches.  On the card the closed-form groups are
one ``tree_glasso`` launch each (lambdas read per block through the
launcher's lane stride), the iterative groups one ``bucket_glasso`` launch
each (per-lane lambdas and convergence scales).  The port has no compile
step, so where the reference reports compiled-cache hits the CLI reports
the per-kernel launch counters (``kernels.*.launches``) instead.

Structure routing extends this in two ways.  Inside a
batch, buckets are coalesced per (padded size, route): closed-form buckets
share one batched forest-kernel call, chordal buckets are solved directly on
the host, and only the iterative remainder pays solver iterations — all
verified with iterative fallback, exactly like the engine executor.  And at
ADMISSION, a request whose plan is entirely fast-path (no "general" bucket)
is solved synchronously on the caller's thread and NEVER ENTERS the dispatch
queue: a microseconds-cheap closed-form solve should not wait out the
batching window behind an iterative co-traveller.

    PYTHONPATH=src python -m repro_torch.launch.serve_glasso --requests 8 --p 60
    PYTHONPATH=src python -m repro_torch.launch.serve_glasso --device cpu

THE CONTROL PLANE (``launch.control_plane``): every
admission verb is one — ``submit(spec, meta=RequestMeta(...))`` — where the
spec says WHAT to solve (``DenseSpec(S, lam)`` / ``DataSpec(X, lam,
session=...)`` / ``JointSpec(Ss=..., lam1=..., lam2=...)``) and the meta says
HOW to treat it: ``tenant`` charges a per-tenant token bucket (``quotas=`` /
``default_quota=``; exhausted buckets raise a typed ``Overload`` from submit,
reason="quota"); ``slo="interactive"`` keeps the admission fast path and
dequeues ahead of every "batch" request, ``slo="batch"`` is best-effort and
yields both; ``deadline`` (relative seconds) drops the request BEFORE
dispatch with ``DeadlineExceeded`` once expired — a dead request never burns
a solver.  ``max_queue=`` bounds the dispatch queue (full = ``Overload``
reason="queue", raised synchronously — no future that hangs a timeout), and
``result_cache=`` adds an LRU over finished results keyed by (payload
fingerprint, lambdas, penalty, K, output): an identical re-submission
returns the finished result with zero planner work.  The historical verbs — ``submit(S, lam)``, ``submit_data``,
``submit_joint`` — still work as deprecated shims over the same chokepoint.

DATA-MATRIX ADMISSION (``DataSpec``) accepts the raw (n, p) X instead of
a covariance: screening runs out-of-core through ``repro_torch.stream`` (the
``covgram_screen`` kernel on the card; the dense
S never exists — materialized per-component blocks flow through the same
planner/batcher), and a named ``session`` pins the screen state so
``append_rows`` can absorb rank-k data updates INCREMENTALLY: only tiles
whose perturbation certificate broke are re-screened, affected components
merge/split, and the fresh solve warm-starts from the session's previous
solution (untouched components start essentially converged — the serving
analog of the path warm start).

PATH ADMISSION (``PathSpec``) turns the server into a model-selection
service: ``submit(PathSpec(S=S, grid={"auto": 20}, criterion="ebic",
n=...))`` (or ``X=`` for the out-of-core form, required by the resampling
criteria "cv"/"stars") runs the warm-started homotopy path over the whole
descending grid on the batcher thread via ``repro_torch.select.select_path`` —
LITERALLY that function, so the served ``Selection`` (selected graph +
per-lambda diagnostics + warm-start accounting) is bitwise identical to
the offline call on the same inputs.  Path requests default to the
"batch" SLO (a grid of solves should not jump interactive co-travellers;
an explicit ``RequestMeta(slo="interactive")`` overrides), never take the
admission fast path, and cache by (payload fingerprint, grid, criterion +
parameters, output) like every other cacheable kind.

JOINT ADMISSION (``JointSpec``) accepts K class covariances (or K data
matrices via ``Xs=``) estimated jointly under the fused/group penalty
(``repro_torch.joint``): the exact hybrid thresholding screen and the joint
plan run on the caller's thread, an all-closed-form plan (singletons +
identical-block forest components) solves synchronously at admission, and
everything else queues for the batcher, which solves joint buckets through
the shared ``JointEngine`` (its ADMM runs the ``joint_prox`` kernel on the
card).

COUNTER NAMESPACES surfaced by ``serve_stats()``: ``serve.*``, ``stream.*``,
``solver.oversize.*``, ``solver.fused.*``, ``joint.*``, ``select.*``,
``engine.*``, ``result.*`` and ``kernels.*`` (the card's launch counts).
The counters are flat entries in the process-global ``repro_torch.obs``
registry, so every name is also exported verbatim — dots sanitized to
underscores — by ``GlassoServer.metrics()`` (Prometheus text exposition)
alongside the labeled ``serve.request_seconds`` latency histogram.

OBSERVABILITY (``repro_torch.obs``): every admitted request
carries a ``Trace`` rooted at ``serve.request`` (attrs: tenant, slo, kind).
Admission-time work — screen, plan, the synchronous fast path — records
spans on the caller's thread; queued work re-enters the request's trace on
the batcher thread through the EXPLICIT token handoff (``activate``; the
contextvar does not follow the queue), and the finished trace rides both
the result (``result.trace``) and the future (``future.trace``).  Export
one with ``trace.to_chrome_json(path)`` and open it in Perfetto /
chrome://tracing.  Request latency (admission to future resolution) lands
in the ``serve.request_seconds`` histogram labeled (tenant, slo, kind in
{dense, data, joint, path, session}), so the server itself answers
p50/p99-per-tenant questions: ``REGISTRY.quantile("serve.request_seconds",
0.99, slo="interactive")``.  One attribution rule: a COALESCED solver
dispatch serves many requests at once and is therefore never recorded in
any single request's trace — per-request spans cover plan and assembly;
the shared dispatch stays visible in ``engine.dispatch.*``.

SPARSE RESULTS (``output=``): the server-level ``output`` ("dense" /
"sparse" / "auto", default "auto") picks the result representation for
every admission path, and each request can override it via
``RequestMeta(output=...)``.  "auto" resolves per request from its p
(sparse above ``core.sparse.AUTO_SPARSE_P``); a sparse result's ``Theta``
is a ``SparseTheta`` / ``JointSparseTheta`` — per-component padded block
stacks, edge lists via ``support_edges()``, CSR via ``to_csr()`` —
assembled with ZERO (p, p) allocation, so serving payloads for huge
requests stay O(sum b_i^2).

OVERSIZE ADMISSION (``oversize_threshold`` / ``oversize_budget_mb`` on
``EngineOptions``): a request whose screen leaves a component past the
single-device block cap is still admitted — the planner classes it
"oversize", the admission fast path declines it (a sharded solve is not
microseconds-cheap), and the batcher dispatches it down the executor's
sharded route: shard-direct gather, the no-eigh ADMM (its prox tail the
``shard_prox`` kernel on the card), KKT verification, iterative fallback on
rejection.  ``GlassoResult.oversize`` carries the per-request
{dispatched, inner_iters, fallbacks}.

SCRATCH UNDER THREADS: requests are solved on the batcher thread and, on
the fast path and for ``append_rows``, on callers' threads at once.  The
kernel wrappers that keep scratch on the card (``covgram_screen``,
``joint_prox``, ``shard_prox``) key it by (device, stream) and enqueue under
a lock, so concurrent solves on one stream interleave whole launches only.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.instrument import bump, counts, timed_dispatch
from repro_torch.launch.control_plane import (
    AdmissionQueue,
    DataSpec,
    DeadlineExceeded,
    DenseSpec,
    JointSpec,
    Overload,
    PathSpec,
    RequestMeta,
    ResultCache,
    TenantBuckets,
    deadline_instant,
    host_array,
    spec_cache_key,
)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Trace, activate, span

_LEGACY_VERB_MSG = (
    "{verb} is deprecated; pass a typed spec — "
    "server.submit({spec}, meta=RequestMeta(tenant=..., slo=..., "
    "deadline=..., output=...)) — see launch.control_plane"
)


@dataclass
class GlassoRequest:
    # dense ndarray, or a stream.MaterializedCovariance for data requests
    # (both satisfy the blocks.py gather protocol the batcher uses)
    S: object
    lam: float
    future: Future = field(default_factory=Future)
    # screen/plan results computed at fast-path admission; reused by the
    # batcher so a queued request is never planned twice
    labels: np.ndarray | None = None
    stats: object = None
    plan: object = None
    # resolved result representation ("dense" | "sparse"), fixed at admission
    output: str = "dense"
    # control-plane identity: accounting tenant, SLO class, and the absolute
    # monotonic expiry (None = never) fixed at admission
    tenant: str = "default"
    slo: str = "interactive"
    deadline_at: float | None = None
    # per-request obs.Trace (None when the server runs trace=False); the
    # batcher re-enters it via _req_scope — the explicit thread handoff
    trace: object = None


@dataclass
class JointRequest:
    """A K-class joint request (``JointSpec``); rides the same queue and
    shutdown drain as plain requests."""

    Ss: object                     # list of dense arrays or materialized covs
    lam1: float
    lam2: float
    penalty: str
    future: Future = field(default_factory=Future)
    labels: np.ndarray | None = None
    stats: object = None
    plan: object = None
    output: str = "dense"
    tenant: str = "default"
    slo: str = "interactive"
    deadline_at: float | None = None
    trace: object = None


@dataclass
class PathRequest:
    """A model-selection request (``PathSpec``): the whole homotopy grid +
    criterion resolve on the batcher thread via ``repro_torch.select.
    select_path`` — literally that function, so a served selection is
    bitwise identical to the offline call on the same inputs/options.
    Rides the same queue, deadline expiry, and shutdown drain as every
    other request kind; never takes the admission fast path (a grid of
    solves is not microseconds-cheap) and defaults to the "batch" SLO."""

    spec: PathSpec
    future: Future = field(default_factory=Future)
    output: str = "dense"
    tenant: str = "default"
    slo: str = "batch"
    deadline_at: float | None = None
    trace: object = None


def _request_kind(spec) -> str:
    """The histogram/trace ``kind`` label for one admission spec."""
    if isinstance(spec, DenseSpec):
        return "dense"
    if isinstance(spec, DataSpec):
        return "data"
    if isinstance(spec, PathSpec):
        return "path"
    return "joint"


def _req_scope(req):
    """Re-enter a queued request's trace on the batcher thread.

    The explicit cross-thread handoff: the contextvar does not follow the
    queue, and implicit inheritance would pin every batcher span to
    whichever request started the thread."""
    tr = getattr(req, "trace", None)
    if tr is None:
        return nullcontext()
    return activate((tr, tr.root_id))


@dataclass
class _SessionEntry:
    session: object                # stream.DataSession
    last: Future | None = None     # most recent solve (warm-start source)
    # serializes append_rows per session: the warm-start read and the
    # `last` write must be one transaction, and DataSession state must not
    # interleave between concurrent appends
    lock: threading.Lock = field(default_factory=threading.Lock)


@dataclass
class _PlacedBucket:
    request: "GlassoRequest"
    plan: object
    bucket: object


class GlassoServer:
    """Coalescing batch server over the engine executor.

    ``submit(spec, meta=...)`` is thread-safe and returns a Future resolving
    to the engine's ``GlassoResult`` (or raises ``Overload`` synchronously
    when the control plane refuses admission).  ``max_delay`` is the
    batching window: the batcher waits that long after the first queued
    request for co-travellers before dispatching (classic serving
    latency/throughput knob).

    Engine configuration travels as ``options=EngineOptions(...)`` — the
    same typed object ``glasso``/``joint_glasso`` accept; legacy bare
    engine kwargs (``solver=``, ``route=``, ``tol=``, ...) still normalize
    through the shared chokepoint.  The server solves on
    ``options.device``: ``"cuda"`` by default, which raises
    ``RuntimeError`` without CUDA; ``EngineOptions(device="cpu")`` runs the
    kernels' plain versions.  Control-plane knobs are the server's own:
    ``quotas`` (tenant -> ``control_plane.Quota``), ``default_quota``
    (unlisted tenants; None = unmetered), ``max_queue`` (0 = unbounded),
    ``result_cache`` (LRU entries; 0 = off — fingerprinting a request
    costs one sha1 pass over its payload, so caching is opt-in)."""

    def __init__(
        self,
        *,
        options=None,
        max_delay: float = 0.005,
        max_batch: int = 64,
        fast_path: bool = True,
        quotas: dict | None = None,
        default_quota=None,
        max_queue: int = 0,
        result_cache: int = 0,
        **legacy_engine_kwargs,
    ):
        from repro_torch.core.solvers import SOLVERS, solver_spec
        from repro_torch.engine.api import resolve_oversize
        from repro_torch.engine.executor import BucketExecutor, _validate_solver_opts
        from repro_torch.engine.options import normalize_options

        opts = normalize_options(
            options, legacy_engine_kwargs, context="GlassoServer"
        )
        if opts.trace == "jax":
            raise NotImplementedError("trace='jax' annotates JAX profiles; use trace=True")
        solver = opts.resolved_solver("bcd")
        if solver not in SOLVERS:
            raise ValueError(
                f"unknown solver {solver!r}; available: {sorted(SOLVERS)}"
            )
        solver_opts = dict(opts.solver_opts)
        _validate_solver_opts(solver, solver_opts)
        self.options = opts
        self.solver = solver
        self.output = opts.output
        self.dtype = opts.resolved_dtype()
        self.device = opts.resolved_device()  # no CUDA and no "cpu": raises
        self.cc_backend = opts.cc_backend
        self.max_delay = max_delay
        self.max_batch = max_batch
        self.route = opts.route
        self.fast_path = fast_path and opts.route
        self.route_check_tol = opts.route_check_tol
        # single-device block cap: larger components are ADMITTED (not
        # rejected) and routed down the sharded path by the batcher — an
        # oversize request just never takes the synchronous admission fast
        # path (a sharded solve is not "microseconds-cheap")
        self.oversize = resolve_oversize(
            opts.oversize_threshold, opts.oversize_budget_mb,
            opts.np_dtype(), route=opts.route, device=self.device,
        )
        self.solver_opts = solver_opts
        # admission-time fast-path solver: a stateless ladder executor
        self._fast_executor = BucketExecutor(
            solver=solver,
            dtype=self.dtype,
            device=self.device,
            solver_opts=dict(solver_opts),
            route=True,
            route_check_tol=self.route_check_tol,
        )
        # data sessions: named streaming-screen states for append_rows; the
        # session executor honors the server's route setting (the admission
        # fast-path executor is route=True by definition)
        self._session_executor = BucketExecutor(
            solver=solver,
            dtype=self.dtype,
            device=self.device,
            solver_opts=dict(solver_opts),
            route=opts.route,
            route_check_tol=self.route_check_tol,
        )
        self._spec = solver_spec(solver)
        self._sessions: dict[str, _SessionEntry] = {}
        self._sessions_lock = threading.Lock()
        # control plane: per-tenant token buckets, the bounded two-class
        # priority queue, and the finished-result LRU
        self._quotas = TenantBuckets(
            quotas=dict(quotas or {}), default=default_quota
        )
        self._queue = AdmissionQueue(maxsize=max_queue)
        self._cache = ResultCache(result_cache)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._joint = None  # lazily-built JointEngine (repro_torch.joint)
        self._joint_lock = threading.Lock()

    def _joint_engine(self):
        """The server's shared K-class engine (``repro_torch.joint.
        JointEngine``).

        Built lazily so single-class servers never import the joint stack.
        Solver options are the intersection of the server's opts with what
        ``joint_admm`` accepts (tol/max_iter/rho travel; bcd-specific knobs
        do not)."""
        with self._joint_lock:
            if self._joint is None:
                import inspect

                from repro_torch.joint.admm import joint_admm
                from repro_torch.joint.engine import JointEngine

                accepted = set(inspect.signature(joint_admm).parameters)
                joint_opts = self.options.replace(
                    solver=None,  # JointEngine resolves its own default
                    oversize_threshold=None,
                    oversize_budget_mb=None,
                    solver_opts={
                        k: v for k, v in self.solver_opts.items() if k in accepted
                    },
                )
                self._joint = JointEngine(options=joint_opts)
            return self._joint

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "GlassoServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_pending()

    def _fail_pending(self) -> None:
        """Fail queued requests fast instead of letting their clients block
        out the full result() timeout.  Called from stop() and from the
        admission chokepoint when an enqueue loses the shutdown race."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("GlassoServer stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def _resolve_output(self, output: str | None, p: int) -> str:
        """Fix a request's result representation at admission: the request
        ``meta.output`` overrides the server default; "auto" resolves from
        p."""
        from repro_torch.core.sparse import resolve_output

        return resolve_output(self.output if output is None else output, p)

    @staticmethod
    def _fold_output(
        meta: RequestMeta | None, output: str | None, *, spec=None
    ) -> RequestMeta:
        """Merge the legacy per-call ``output=`` kwarg into the meta.

        When the caller supplied no meta at all, the default SLO is spec-
        aware: path requests (``PathSpec``) admit as "batch" — a whole grid
        of solves should not jump interactive co-travellers — while every
        other kind keeps the historical "interactive" default.  An explicit
        ``RequestMeta(slo=...)`` always wins."""
        if meta is None:
            meta = RequestMeta(
                slo="batch" if isinstance(spec, PathSpec) else "interactive"
            )
        if output is None:
            return meta
        if meta.output is not None:
            raise TypeError(
                "output= conflicts with meta.output; set it in RequestMeta"
            )
        return replace(meta, output=output)

    def submit(
        self,
        spec,
        lam: float | None = None,
        *,
        output: str | None = None,
        meta: RequestMeta | None = None,
    ) -> Future:
        """Admit ONE request of any kind: ``submit(spec, meta=...)``.

        ``spec`` is a ``DenseSpec`` / ``DataSpec`` / ``JointSpec`` /
        ``PathSpec`` (``launch.control_plane``); ``meta`` carries tenant,
        SLO class, deadline, and the per-request output override.  Returns
        a Future resolving to the engine result — or raises ``Overload``
        synchronously when the tenant's token bucket is dry or the bounded
        queue is full (backpressure is an exception, never a hung future).

        The historical form ``submit(S, lam)`` still works as a deprecated
        shim (one ``DeprecationWarning``) and is equivalent to
        ``submit(DenseSpec(S, lam))``."""
        if not isinstance(spec, (DenseSpec, DataSpec, JointSpec, PathSpec)):
            warnings.warn(
                _LEGACY_VERB_MSG.format(
                    verb="submit(S, lam)", spec="DenseSpec(S, lam)"
                ),
                DeprecationWarning,
                stacklevel=2,
            )
            if lam is None:
                raise TypeError("legacy submit(S, lam) needs lam")
            spec = DenseSpec(S=host_array(spec), lam=float(lam))
        elif lam is not None:
            raise TypeError(
                "submit(spec) takes no positional lam — it lives on the spec"
            )
        return self._submit(spec, self._fold_output(meta, output, spec=spec))

    def submit_data(
        self,
        X,
        lam: float,
        *,
        session: str | None = None,
        stream=None,
        output: str | None = None,
    ) -> Future:
        """Deprecated shim: ``submit(DataSpec(X, lam, session=...,
        stream=...))`` — see that path for semantics."""
        warnings.warn(
            _LEGACY_VERB_MSG.format(
                verb="submit_data", spec="DataSpec(X, lam, session=...)"
            ),
            DeprecationWarning,
            stacklevel=2,
        )
        spec = DataSpec(X=X, lam=float(lam), session=session, stream=stream)
        return self._submit(spec, self._fold_output(None, output))

    def submit_joint(
        self,
        Ss=None,
        lam1: float | None = None,
        lam2: float = 0.0,
        *,
        penalty: str = "group",
        Xs=None,
        stream=None,
        output: str | None = None,
    ) -> Future:
        """Deprecated shim: ``submit(JointSpec(Ss=..., lam1=..., lam2=...))``
        — see that path for semantics."""
        warnings.warn(
            _LEGACY_VERB_MSG.format(
                verb="submit_joint", spec="JointSpec(Ss, lam1, lam2)"
            ),
            DeprecationWarning,
            stacklevel=2,
        )
        if lam1 is None:
            raise ValueError("submit_joint needs lam1")
        try:
            spec = JointSpec(
                Ss=Ss, lam1=float(lam1), lam2=float(lam2),
                penalty=penalty, Xs=Xs, stream=stream,
            )
        except ValueError as e:
            # legacy contract: malformed joint payloads fail via the future
            fut: Future = Future()
            fut.set_exception(e)
            return fut
        return self._submit(spec, self._fold_output(None, output))

    # -- the admission chokepoint ------------------------------------------

    def _submit(self, spec, meta: RequestMeta) -> Future:
        """Every admission path in one place: stop-check, result cache,
        tenant quota, then the spec-kind handoff.  Centralizing the
        stop-check here (plus the post-enqueue sweep in ``_enqueue``) is
        what closes the shutdown race where a data/joint admission could
        enqueue after ``stop()``'s drain and hang its client."""
        if self._stop.is_set():
            fut: Future = Future()
            fut.set_exception(RuntimeError("GlassoServer stopped"))
            return fut
        kind = _request_kind(spec)
        t_admit = time.perf_counter()
        out = self._resolve_output(meta.output, spec.p)
        key = spec_cache_key(spec, out) if self._cache.maxsize > 0 else None
        if key is not None:
            cached = self._cache.get(key)
            if cached is not None:
                bump("serve.requests")
                bump("serve.cache.hits")
                REGISTRY.observe(
                    "serve.request_seconds",
                    time.perf_counter() - t_admit,
                    tenant=meta.tenant, slo=meta.slo, kind=kind,
                )
                fut = Future()
                fut.set_result(cached)
                return fut
            bump("serve.cache.misses")
        if not self._quotas.try_admit(meta.tenant):
            bump("serve.rejected.quota")
            raise Overload(
                f"tenant {meta.tenant!r} exceeded its admission quota",
                reason="quota",
                tenant=meta.tenant,
            )
        bump("serve.requests")
        tr = (
            Trace("serve.request", tenant=meta.tenant, slo=meta.slo, kind=kind)
            if self.options.trace
            else None
        )
        # admission-time work (screen / plan / fast-path solve) records
        # spans on THIS thread; queued remainders re-enter via _req_scope
        with activate((tr, tr.root_id)) if tr is not None else nullcontext():
            if isinstance(spec, DenseSpec):
                fut = self._admit_dense(spec, meta, out, key, tr)
            elif isinstance(spec, DataSpec):
                fut = self._admit_data(spec, meta, out, key, tr)
            elif isinstance(spec, PathSpec):
                fut = self._admit_path(spec, meta, out, key, tr)
            else:
                fut = self._admit_joint(spec, meta, out, key, tr)
        self._finish_on_done(fut, tr, t_admit, kind, meta)
        return fut

    def _finish_on_done(
        self, fut: Future, tr, t_admit: float, kind: str, meta: RequestMeta
    ) -> None:
        """Terminal observability for one admitted request: the trace rides
        the future, and whichever thread resolves it closes the trace and
        records admission-to-resolution latency in the labeled
        ``serve.request_seconds`` histogram (errors included — a rejected
        dispatch is still a served request)."""
        if tr is not None:
            fut.trace = tr

        def _done(_f, tr=tr, t_admit=t_admit, kind=kind, meta=meta):
            if tr is not None:
                tr.finish()
            REGISTRY.observe(
                "serve.request_seconds",
                time.perf_counter() - t_admit,
                tenant=meta.tenant, slo=meta.slo, kind=kind,
            )

        fut.add_done_callback(_done)

    def _attach_cache_fill(self, fut: Future, key) -> None:
        """Write-through on success: a cacheable request's finished result
        lands in the LRU whichever path (fast path, batcher, repair) solved
        it."""
        if key is None:
            return

        def _fill(f: Future, key=key):
            if not f.cancelled() and f.exception() is None:
                self._cache.put(key, f.result())

        fut.add_done_callback(_fill)

    def _enqueue(self, req) -> Future:
        """Bounded enqueue + the shutdown-race sweep, shared by every
        admission kind."""
        if not self._queue.try_put(req, slo=req.slo):
            bump("serve.rejected.queue")
            raise Overload(
                f"dispatch queue full (max_queue={self._queue.maxsize})",
                reason="queue",
                tenant=req.tenant,
            )
        if self._stop.is_set():
            # lost the race against stop(): its drain may have run before our
            # put landed, so sweep the queue ourselves
            self._fail_pending()
        return req.future

    def _admit_dense(self, spec: DenseSpec, meta, out: str, key, tr) -> Future:
        req = GlassoRequest(
            S=host_array(spec.S), lam=float(spec.lam), output=out,
            tenant=meta.tenant, slo=meta.slo,
            deadline_at=deadline_instant(meta), trace=tr,
        )
        self._attach_cache_fill(req.future, key)
        # the fast path is the interactive SLO's half of the contract: batch
        # requests always take the queue (and yield the window)
        if self.fast_path and meta.slo == "interactive":
            if self._try_fast_path(req):
                return req.future
        return self._enqueue(req)

    def _admit_data(self, spec: DataSpec, meta, out: str, key, tr) -> Future:
        """Data-matrix admission: the out-of-core screen runs on the
        caller's thread (``repro_torch.stream``: the ``covgram_screen``
        kernel + compacted edges + materialized per-component blocks — the
        dense S never exists), then the request takes the normal path:
        solved synchronously if every bucket routes non-iteratively
        (interactive only), queued otherwise.

        ``spec.session`` pins the streaming screen state so later
        ``append_rows(name, Y)`` calls re-screen incrementally; without it
        the screen runs stateless (no per-tile records, no retained X —
        nothing a one-shot request would ever use)."""
        from repro_torch.engine.planner import build_plan_incremental
        from repro_torch.stream import DataSession, stream_screen

        bump("serve.data_requests")
        req = GlassoRequest(
            S=None, lam=float(spec.lam), output=out,
            tenant=meta.tenant, slo=meta.slo,
            deadline_at=deadline_instant(meta), trace=tr,
        )
        self._attach_cache_fill(req.future, key)
        try:
            with span("serve.plan", source="data"):
                if spec.session is not None:
                    ses = DataSession(
                        spec.X, req.lam, config=spec.stream,
                        oversize=self.oversize, device=self.device,
                    )
                    req.S, req.labels, req.stats = ses.S, ses.labels, ses.stats
                    with self._sessions_lock:
                        self._sessions[spec.session] = _SessionEntry(
                            session=ses, last=req.future
                        )
                else:
                    sc = stream_screen(
                        spec.X, [req.lam], config=spec.stream,
                        oversize=self.oversize, device=self.device,
                    )
                    req.S, req.labels, req.stats = (
                        sc.S, sc.labels[0], sc.stats[0]
                    )
                req.plan, _ = build_plan_incremental(
                    req.S, req.lam, req.labels, classify_structures=self.route,
                    oversize=self.oversize,
                )
        except Exception as e:  # delivered through the request's future
            req.future.set_exception(e)
            return req.future
        if self.fast_path and meta.slo == "interactive":
            try:
                if self._solve_if_fastpath(req):
                    return req.future
            except Exception as e:  # delivered through the request's future
                req.future.set_exception(e)
                return req.future
        return self._enqueue(req)

    def _admit_joint(self, spec: JointSpec, meta, out: str, key, tr) -> Future:
        """K-class joint admission (``repro_torch.joint``): the exact hybrid
        thresholding screen and the joint plan run on the caller's thread;
        a plan whose every union bucket routes non-iteratively (singletons
        + identical-block forest components) is solved synchronously at
        admission (interactive only), everything else queues for the
        batcher.  Shutdown drains joint futures through the same
        ``_fail_pending`` path as every other request kind."""
        bump("joint.requests")
        req = JointRequest(
            Ss=None, lam1=float(spec.lam1), lam2=float(spec.lam2),
            penalty=spec.penalty, output=out,
            tenant=meta.tenant, slo=meta.slo,
            deadline_at=deadline_instant(meta), trace=tr,
        )
        self._attach_cache_fill(req.future, key)
        try:
            engine = self._joint_engine()
            with span("serve.plan", kind="joint"):
                if spec.Xs is not None:
                    from repro_torch.joint.stream import joint_stream_screen

                    sc = joint_stream_screen(
                        spec.Xs, req.lam1, req.lam2, penalty=spec.penalty,
                        config=spec.stream, device=self.device,
                    )
                    req.Ss, req.labels, req.stats = sc.S, sc.labels, sc.stats
                else:
                    req.Ss = [host_array(S) for S in spec.Ss]
                    req.labels, req.stats = engine.screen(
                        req.Ss, req.lam1, req.lam2, penalty=spec.penalty
                    )
                req.plan = engine.plan(
                    req.Ss, req.lam1, req.lam2, req.labels,
                    penalty=spec.penalty,
                )
        except Exception as e:  # delivered through the request's future
            req.future.set_exception(e)
            return req.future
        if self.fast_path and meta.slo == "interactive":
            from repro_torch.engine.registry import route_for

            if not any(
                route_for(b.structure) in ("iterative", "sharded")
                for b in req.plan.buckets
            ):
                self._solve_joint_request(req)
                bump("joint.fastpath_requests")
                bump("serve.fastpath_requests")
                return req.future
        return self._enqueue(req)

    def _admit_path(self, spec: PathSpec, meta, out: str, key, tr) -> Future:
        """Model-selection admission: validation already ran in the spec's
        ``__post_init__``; the homotopy grid + criterion run entirely on the
        batcher thread (``_solve_path_request``), so admission just queues.
        There is deliberately NO fast path — even an all-closed-form grid is
        n_points solves plus scoring, not a microseconds-cheap call."""
        bump("serve.path_requests")
        req = PathRequest(
            spec=spec, output=out, tenant=meta.tenant, slo=meta.slo,
            deadline_at=deadline_instant(meta), trace=tr,
        )
        self._attach_cache_fill(req.future, key)
        return self._enqueue(req)

    def _solve_path_request(self, req: PathRequest) -> None:
        """Resolve one path request by calling ``repro_torch.select.
        select_path`` — literally the offline entry point, with the
        server's options and the admission-resolved output — so the served
        ``Selection`` (the selected graph + per-lambda diagnostics) is
        bitwise identical to the same call made locally."""
        from repro_torch.select import select_path

        try:
            spec = req.spec
            with _req_scope(req):
                # select_path's trace_request degrades to a child span under
                # the request trace — serving owns the root
                selection = select_path(
                    spec.S,
                    X=spec.X,
                    grid=spec.grid,
                    criterion=spec.criterion,
                    n=spec.n,
                    gamma=spec.gamma,
                    options=self.options,
                    stream=spec.stream,
                    output=req.output,
                    criterion_opts=spec.criterion_opts,
                )
            req.future.set_result(selection)
        except Exception as e:  # delivered through the request's future
            if not req.future.done():
                req.future.set_exception(e)

    def _solve_joint_request(self, req: JointRequest) -> None:
        """Solve one planned joint request through the shared JointEngine
        (on the card its ADMM iterations run the ``joint_prox`` kernel)."""
        from repro_torch.joint.api import _joint_result

        try:
            engine = self._joint_engine()
            with _req_scope(req):
                t0 = time.perf_counter()
                Theta, fallbacks = engine.solve_plan(
                    req.plan, req.Ss, output=req.output
                )
                seconds = time.perf_counter() - t0
                req.future.set_result(
                    _joint_result(
                        req.plan, req.labels, req.stats, Theta, seconds,
                        "joint_admm", routed=self.route, fallbacks=fallbacks,
                        assemble_seconds=engine.last_assemble_seconds,
                    )
                )
        except Exception as e:  # delivered through the request's future
            if not req.future.done():
                req.future.set_exception(e)

    def metrics(self) -> str:
        """The serving /metrics surface: Prometheus text exposition of the
        process-global ``repro_torch.obs`` registry — every flat counter
        ``serve_stats()`` reports (dots sanitized to underscores) plus the
        labeled ``serve.request_seconds`` histogram, whose ``_bucket`` /
        ``_sum`` / ``_count`` series give any scraper (or
        ``REGISTRY.quantile``) per-tenant/SLO/kind p50/p99 server-side."""
        from repro_torch.obs.metrics import render_prometheus

        return render_prometheus()

    def append_rows(self, session: str, Y) -> Future:
        """Absorb k new data rows into a named session and re-solve.

        The re-screen is INCREMENTAL (``stream.DataSession``): only tiles
        whose perturbation certificate broke are recomputed
        (``stream.tiles_rescreened`` vs ``stream.tiles_revalidated``),
        affected components merge/split, blocks re-materialize exactly from
        the updated X.  The solve runs synchronously on the caller's thread
        — updates are latency-sensitive and warm-start from the session's
        previous solution (all surviving components begin essentially
        converged), so they never wait out the batching window."""
        from repro_torch.core.solvers import WARM_START_SOLVERS
        from repro_torch.engine.api import _result, blockwise_inverse
        from repro_torch.engine.planner import build_plan_incremental

        with self._sessions_lock:
            entry = self._sessions.get(session)
        if entry is None:
            raise KeyError(
                f"unknown data session {session!r}; open one with "
                "submit(DataSpec(X, lam, session=...))"
            )
        bump("serve.session_updates")
        tr = (
            Trace(
                "serve.request", tenant="default", slo="interactive",
                kind="session", session=session,
            )
            if self.options.trace
            else None
        )
        t_admit = time.perf_counter()
        fut: Future = Future()
        if tr is not None:
            fut.trace = tr
        scope = activate((tr, tr.root_id)) if tr is not None else nullcontext()
        # appends on one session are a serial history
        with entry.lock, scope:
            try:
                prev = None
                if (
                    entry.last is not None
                    and entry.last.done()
                    and entry.last.exception() is None
                ):
                    prev = entry.last.result()
                up = entry.session.append_rows(Y)
                plan, _ = build_plan_incremental(
                    up.S, entry.session.lam, up.labels,
                    classify_structures=self.route, oversize=self.oversize,
                )
                warm_W = None
                if prev is not None and self.solver in WARM_START_SOLVERS:
                    # warm-start only the iterative-routed buckets (same
                    # restriction as the engine path): inverting an OVERSIZE
                    # block on the host would cost exactly the O(b^3) memory/
                    # compute the sharded route exists to avoid — and the
                    # sharded dispatch ignores warm_W anyway
                    from repro_torch.engine.registry import route_for

                    needed = np.zeros(up.S.shape[0], dtype=bool)
                    for b in plan.buckets:
                        if not self.route or route_for(b.structure) == "iterative":
                            for c in b.comps:
                                needed[c] = True
                    if self.oversize is not None and needed.any():
                        # a split can hand an old giant's vertex to a small
                        # new bucket; blockwise_inverse works on the OLD
                        # partition, so old oversize components stay excluded
                        from repro_torch.core.components import component_lists

                        for comp in component_lists(prev.labels):
                            if comp.size > self.oversize:
                                needed[comp] = False
                    if needed.any():
                        warm_W = blockwise_inverse(
                            prev.labels, prev.Theta, needed
                        )
                out_mode = self._resolve_output(None, int(up.S.shape[0]))
                t0 = time.perf_counter()
                ex = self._session_executor
                Theta = ex.solve_plan(
                    plan, entry.session.lam, up.S, warm_W=warm_W,
                    output=out_mode,
                )
                seconds = time.perf_counter() - t0
                fut.set_result(
                    _result(
                        plan, up.labels, up.stats, Theta, seconds, self.solver,
                        entry.session.lam, routed=self.route,
                        oversize=ex.last_oversize,
                        assemble_seconds=ex.last_assemble_seconds,
                        dispatch_seconds=ex.last_dispatch_seconds,
                        device=str(self.device),
                    )
                )
            except Exception as e:  # delivered through the future
                fut.set_exception(e)
            entry.last = fut
        if tr is not None:
            tr.finish()
        REGISTRY.observe(
            "serve.request_seconds",
            time.perf_counter() - t_admit,
            tenant="default", slo="interactive", kind="session",
        )
        return fut

    def _try_fast_path(self, req: GlassoRequest) -> bool:
        """Solve entirely-fast-path requests at admission, skipping the
        dispatch queue.

        Screens and plans on the caller's thread (cheap, O(p^2)); if every
        bucket ROUTES non-iteratively (``registry.route_for``, so
        ``set_route`` re-routing is honored), the ladder executor solves it
        synchronously — one ``tree_glasso`` launch a closed-form bucket,
        including the rare KKT-fallback re-dispatch — and the future
        resolves with zero queueing delay.  Returns False (request not
        handled) when any bucket needs the iterative solver; the
        screen/plan results are stashed on the request so the batcher
        does not redo them."""
        from repro_torch.core.screening import thresholded_components
        from repro_torch.engine.planner import build_plan_incremental

        try:
            with span("serve.plan"):
                labels, stats = thresholded_components(
                    req.S, req.lam, backend=self.cc_backend, device=self.device
                )
                plan, _ = build_plan_incremental(
                    req.S, req.lam, labels, oversize=self.oversize
                )
            req.labels, req.stats, req.plan = labels, stats, plan
            return self._solve_if_fastpath(req)
        except Exception as e:  # delivered through the request's future
            req.future.set_exception(e)
            return True

    def _solve_if_fastpath(self, req: GlassoRequest) -> bool:
        """Admission-time synchronous solve of an already-planned request
        whose every bucket routes non-iteratively; False = needs the queue."""
        from repro_torch.engine.api import _result
        from repro_torch.engine.registry import route_for

        if any(
            route_for(b.structure) in ("iterative", "sharded")
            for b in req.plan.buckets
        ):
            # sharded blocks are blocking solves — never admission-
            # synchronous; they queue for the batcher like iterative work
            return False
        t0 = time.perf_counter()
        ex = self._fast_executor
        Theta = ex.solve_plan(req.plan, req.lam, req.S, output=req.output)
        seconds = time.perf_counter() - t0
        bump("serve.fastpath_requests")
        bump(
            "serve.fastpath_blocks",
            int(
                len(req.plan.isolated)
                + sum(len(b.comps) for b in req.plan.buckets)
            ),
        )
        req.future.set_result(
            _result(
                req.plan, req.labels, req.stats, Theta, seconds, self.solver,
                req.lam, routed=True,
                assemble_seconds=ex.last_assemble_seconds,
                dispatch_seconds=ex.last_dispatch_seconds,
                device=str(self.device),
            )
        )
        return True

    # -- batcher -----------------------------------------------------------

    def _drain(self) -> list[GlassoRequest]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _expire(self, batch: list) -> list:
        """Deadline propagation: drop expired requests BEFORE dispatch —
        a dead request never reaches ``solve_batch``."""
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline_at is not None and now >= req.deadline_at:
                bump("serve.rejected.deadline")
                if not req.future.done():
                    req.future.set_exception(
                        DeadlineExceeded(
                            f"deadline expired before dispatch "
                            f"(tenant={req.tenant!r})"
                        )
                    )
            else:
                live.append(req)
        return live

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._expire(self._drain())
            if not batch:
                continue
            # strict SLO ordering: the interactive sub-batch dispatches
            # first (batch-class work trades its coalescing opportunity for
            # the interactive class's latency — the queue already dequeues
            # interactive first, this keeps a mixed drain honest too)
            interactive = [r for r in batch if r.slo == "interactive"]
            best_effort = [r for r in batch if r.slo != "interactive"]
            for sub in (interactive, best_effort):
                if not sub:
                    continue
                try:
                    self.solve_batch(sub)
                except Exception as e:  # the batcher keeps serving
                    for req in sub:
                        if not req.future.done():
                            req.future.set_exception(e)

    # -- the coalescing solve (callable synchronously too) -----------------

    def solve_batch(self, requests: list[GlassoRequest]) -> None:
        """Screen+plan each request, coalesce same-size buckets across ALL
        requests into one kernel launch per (padded size, route), scatter
        back.  Closed-form groups carry their KKT flags through the same
        verify-then-iterative-fallback contract as the engine executor.
        Groups containing an interactive request dispatch first (the queue
        and drain loop already order whole batches; this orders the
        dispatches inside one).  Every launch is queued before the one
        synchronization of the card; chordal and sharded groups solve as
        they are met."""
        from repro_torch.core import blocks as blocks_mod
        from repro_torch.core.screening import thresholded_components
        from repro_torch.engine.api import _result
        from repro_torch.engine.executor import (
            closed_form,
            dispatch_repair,
            solve_chordal_bucket,
            solve_sharded_bucket,
        )
        from repro_torch.engine.planner import build_plan_incremental
        from repro_torch.engine.registry import route_for

        t0 = time.perf_counter()
        # joint requests ride the same queue but their buckets carry the K
        # class axis: each is solved through the shared JointEngine, then
        # the plain requests coalesce as before.  Path requests (PathSpec)
        # resolve whole selection grids through repro_torch.select.
        path_reqs = [r for r in requests if isinstance(r, PathRequest)]
        joint_reqs = [r for r in requests if isinstance(r, JointRequest)]
        requests = [
            r for r in requests if not isinstance(r, (JointRequest, PathRequest))
        ]
        for pr in path_reqs:
            self._solve_path_request(pr)
        for jr in joint_reqs:
            self._solve_joint_request(jr)
        if not requests:
            if joint_reqs or path_reqs:
                bump("serve.batches")
            return
        dev, dtype, opts = self.device, self.dtype, dict(self.solver_opts)
        per_req: list[tuple[GlassoRequest, np.ndarray, object, object]] = []
        groups: dict[tuple[int, str], list[_PlacedBucket]] = {}
        for req in requests:
            if req.plan is not None:  # planned at fast-path admission
                labels, stats, plan = req.labels, req.stats, req.plan
            else:
                with _req_scope(req), span("serve.plan"):
                    labels, stats = thresholded_components(
                        req.S, req.lam, backend=self.cc_backend, device=dev
                    )
                    plan, _ = build_plan_incremental(
                        req.S, req.lam, labels, classify_structures=self.route,
                        oversize=self.oversize,
                    )
            per_req.append((req, labels, stats, plan))
            for bucket in plan.buckets:
                route = route_for(bucket.structure) if self.route else "iterative"
                groups.setdefault((bucket.size, route), []).append(
                    _PlacedBucket(request=req, plan=plan, bucket=bucket)
                )

        bump("serve.batches")

        def _group_priority(item):
            gkey, placed = item
            interactive = any(
                pb.request.slo == "interactive" for pb in placed
            )
            return (0 if interactive else 1,) + gkey

        # one dispatch per (padded size, route), blocks + per-block lambda
        # stacked across requests; all launched before any blocking
        outs: dict[tuple[int, str], object] = {}
        oks: dict[tuple[int, str], object] = {}
        oversize_by_req: dict[int, dict] = {}
        dispatch_seconds = 0.0
        for (size, route), placed in sorted(
            groups.items(), key=_group_priority
        ):
            n_blocks = sum(len(pb.bucket.comps) for pb in placed)
            lams_h = np.concatenate(
                [
                    np.full(len(pb.bucket.comps), pb.request.lam)
                    for pb in placed
                ]
            )
            if route == "sharded":
                # blocking solves; KKT verification + the iterative
                # fallback happen inside solve_sharded_bucket, so the group
                # carries no ok flags to the repair pass below
                stacks = []
                for pb in placed:
                    n = len(pb.bucket.comps)
                    out_pb, info = solve_sharded_bucket(
                        pb.bucket,
                        np.full(n, pb.request.lam),
                        pb.request.S,
                        solver=self.solver,
                        dtype=dtype,
                        device=dev,
                        opts=opts,
                        tol=self.route_check_tol,
                    )
                    stacks.append(out_pb)
                    acc = oversize_by_req.setdefault(
                        id(pb.request),
                        {"dispatched": 0, "inner_iters": 0, "fallbacks": 0},
                    )
                    for k in acc:
                        acc[k] += info[k]
                outs[(size, route)] = np.concatenate(stacks)
                bump("serve.dispatches")
                n_reqs = len({id(pb.request) for pb in placed})
                if n_reqs > 1:
                    bump("serve.coalesced_blocks", n_blocks)
                continue
            if route == "chordal":
                solved = []
                for pb in placed:
                    res, dt = timed_dispatch(
                        solve_chordal_bucket,
                        pb.bucket,
                        np.full(len(pb.bucket.comps), pb.request.lam),
                        tol=self.route_check_tol,
                    )
                    solved.append(res)
                    dispatch_seconds += dt
                outs[(size, route)] = np.concatenate([s[0] for s in solved])
                oks[(size, route)] = np.concatenate([s[1] for s in solved])
                bump("serve.fastpath_blocks", n_blocks)
                bump("serve.dispatches")  # one solver group, host-executed
            else:
                stacked = torch.cat(
                    [torch.as_tensor(pb.bucket.blocks, dtype=dtype, device=dev)
                     for pb in placed]
                )
                lams = torch.as_tensor(lams_h, dtype=dtype, device=dev)
                if route == "closed_form":
                    # one tree_glasso launch for the group, lambdas per block
                    (theta, ok), dt = timed_dispatch(
                        closed_form,
                        stacked,
                        lams,
                        tol=self.route_check_tol,
                        verify=any(
                            pb.bucket.structure != "pair" for pb in placed
                        ),
                    )
                    outs[(size, route)] = theta
                    oks[(size, route)] = ok
                    bump("serve.fastpath_blocks", n_blocks)
                else:
                    # one launch of the configured solver (bucket_glasso for
                    # bcd), per-lane lambdas, cold
                    outs[(size, route)], dt = timed_dispatch(
                        self._spec.fn, stacked, lams, W0=None, Theta0=None, **opts
                    )
                dispatch_seconds += dt
                bump("serve.dispatches")
            n_reqs = len({id(pb.request) for pb in placed})
            if n_reqs > 1:
                bump("serve.coalesced_blocks", n_blocks)
        # single synchronization point: everything above was queued
        with span("engine.barrier"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # verify fast-path groups; repair failures via the shared iterative
        # repair (warm-started from the rejected candidates, same as the
        # engine executor) — only the failed rows are gathered
        for gkey, ok in sorted(oks.items()):
            okh = host_array(ok)
            if okh.all():
                continue
            size, _ = gkey
            idx = np.flatnonzero(~okh)
            bump("serve.fallback_blocks", int(idx.size))
            rows = [
                (pb, i)
                for pb in groups[gkey]
                for i in range(len(pb.bucket.comps))
            ]
            blocks_failed = np.stack(
                [np.asarray(rows[k][0].bucket.blocks)[rows[k][1]] for k in idx]
            )
            lams_failed = np.array([rows[k][0].request.lam for k in idx])
            out = host_array(outs[gkey]).copy()
            fixed = dispatch_repair(
                self.solver, dtype, dev, opts, size, blocks_failed, lams_failed,
                out[idx],
            )
            out[idx] = host_array(fixed)
            outs[gkey] = out

        # scatter solutions back per bucket (stacks are in `placed` order)
        sols_by_bucket: dict[int, np.ndarray] = {}
        for gkey, placed in sorted(groups.items()):
            sols = host_array(outs[gkey])
            k = 0
            for pb in placed:
                n = len(pb.bucket.comps)
                sols_by_bucket[id(pb.bucket)] = sols[k : k + n]
                k += n

        seconds = time.perf_counter() - t0
        # attribute batch wall time to requests by their b^3 solve-cost share
        # (a request's solve_seconds should not count its co-travellers)
        costs = {
            id(req): sum(
                float(len(c)) ** 3 for b in plan.buckets for c in b.comps
            )
            for req, _, _, plan in per_req
        }
        total_cost = sum(costs.values())
        for req, labels, stats, plan in per_req:
            # per-request trace scope: the coalesced dispatches above served
            # MANY requests and stay unattributed (module docstring); only
            # this request's own assembly lands in its span tree, and
            # _result's current_trace() attaches the trace to the result
            with _req_scope(req), span("serve.assemble", output=req.output):
                bucket_sols = [sols_by_bucket[id(b)] for b in plan.buckets]
                ta = time.perf_counter()
                if req.output == "sparse":
                    Theta = blocks_mod.assemble_sparse(plan, bucket_sols, req.S)
                else:
                    Theta = blocks_mod.assemble_dense(plan, bucket_sols, req.S)
                assemble_seconds = time.perf_counter() - ta
                bump("engine.assemble_us", int(assemble_seconds * 1e6))
                share = (
                    costs[id(req)] / total_cost
                    if total_cost > 0
                    else 1.0 / len(per_req)
                )
                req.future.set_result(
                    _result(
                        plan, labels, stats, Theta,
                        seconds * share + assemble_seconds, self.solver,
                        req.lam, routed=self.route,
                        oversize=oversize_by_req.get(id(req)),
                        assemble_seconds=assemble_seconds,
                        dispatch_seconds=dispatch_seconds * share,
                        device=str(dev),
                    )
                )


def serve_stats() -> dict[str, int | float]:
    """Every counter namespace behind the serving surface, in one view.
    Typed ``int | float``: watermark/derived entries record maxima or
    ratios rather than event sums and are not guaranteed integral, so
    consumers must not assume ``int``.  ``kernels.*`` are the card's launch
    counts (zero on the CPU's plain path)."""
    return {
        **counts("serve."),
        **counts("stream."),
        **counts("solver.oversize."),
        **counts("solver.fused."),
        **counts("joint."),
        **counts("select."),
        **counts("engine."),
        **counts("result."),
        **counts("kernels."),
    }


# ---------------------------------------------------------------------------
# CLI demo: N synthetic concurrent clients
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--p", type=int, default=60)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--solver", default="bcd")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; raises without CUDA) or "cpu"')
    args = ap.parse_args(argv)

    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.engine.options import EngineOptions

    reqs = []
    for i in range(args.requests):
        S = paper_synthetic(args.blocks, args.p // args.blocks, seed=i)
        lam_min, lam_max = lambda_interval_for_k(S, args.blocks)
        reqs.append((S, 0.5 * (lam_min + lam_max)))

    options = EngineOptions(
        solver=args.solver, solver_opts={"tol": 1e-7}, device=args.device
    )
    with GlassoServer(options=options) as server:
        t0 = time.perf_counter()
        futures = [
            server.submit(DenseSpec(S, lam), meta=RequestMeta(tenant="demo"))
            for S, lam in reqs
        ]
        results = [f.result(timeout=600) for f in futures]
        dt = time.perf_counter() - t0

    for i, r in enumerate(results):
        print(
            f"req {i}: lam={r.lam:.4f} comps={r.screen.n_components} "
            f"blocks={r.block_sizes}"
        )
    print(f"{len(results)} requests in {dt:.2f}s ({len(results)/dt:.1f} req/s)")
    print("serve counters:", serve_stats())
    # the port has no compile step: the card's launch counters stand where
    # the reference prints its compiled cache
    print("kernel launches:", counts("kernels."))
    # the /metrics surface: show the labeled latency histogram summary lines
    # (full exposition = GlassoServer.metrics(); registry is process-global,
    # so reading it after stop() is fine)
    hist = [
        ln
        for ln in server.metrics().splitlines()
        if ln.startswith("serve_request_seconds_")
        and ("_sum{" in ln or "_count{" in ln)
    ]
    print("metrics (serve_request_seconds):")
    for ln in hist:
        print(" ", ln)
    if results and results[0].trace is not None:
        print(
            "trace (req 0):",
            {k: round(v, 6) for k, v in results[0].trace.stage_seconds().items()},
        )


if __name__ == "__main__":
    main()
