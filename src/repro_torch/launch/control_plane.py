"""Serving control plane: typed request specs, tenant admission, bounded
queues, and result caching for ``launch.serve_glasso.GlassoServer``.

The port's own copy of the reference package's control plane (which
imports no JAX; the port imports nothing of it): the same specs, errors,
buckets, queue and cache, and ``spec_cache_key`` gives the reference's keys
for the same numpy inputs.  A payload may also be a torch tensor, on any
device: it is fingerprinted from its host bytes.

The server's three historical verbs (``submit``/``submit_data``/
``submit_joint``) each grew their own kwarg surface; this module is the
redesign's vocabulary.  WHAT to solve travels as one typed spec —

    DenseSpec(S, lam)                  covariance admission
    DataSpec(X, lam, session=...)      out-of-core data-matrix admission
    JointSpec(Ss=[...], lam1, lam2)    K-class joint admission (or Xs=)
    PathSpec(S|X, grid, criterion)     model selection over a lambda path
                                       (grid = sequence | {"auto": n};
                                       criterion = "ebic" | "cv" | "stars")

— and HOW to treat the request travels as ``RequestMeta``:

    tenant     accounting identity for per-tenant token-bucket quotas
    slo        "interactive" (admission fast path + priority dequeue) or
               "batch" (best-effort; yields the batching window to
               interactive co-travellers)
    deadline   relative seconds; an expired request is dropped BEFORE
               dispatch with ``DeadlineExceeded`` (never solved dead)
    output     per-request result representation override

Overload is EXPLICIT: a full bounded queue or an exhausted tenant bucket
raises ``Overload`` synchronously from ``submit`` (typed, with ``reason``)
instead of parking a future that will time out — backpressure the client
can act on.  ``ResultCache`` sits above the solve: identical (spec bytes,
lambdas, penalty, K, output) re-submissions return the finished result
without touching the planner.

Everything here is engine-agnostic plumbing (no torch imports at module
level): the server composes it; tests exercise it in isolation.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "SLO_CLASSES",
    "AdmissionQueue",
    "DataSpec",
    "DeadlineExceeded",
    "DenseSpec",
    "JointSpec",
    "Overload",
    "PATH_CRITERIA",
    "PathSpec",
    "Quota",
    "RequestMeta",
    "ResultCache",
    "SolveSpec",
    "TenantBuckets",
    "TokenBucket",
    "deadline_instant",
    "fingerprint_array",
    "spec_cache_key",
]

SLO_CLASSES = ("interactive", "batch")


def _shape(A) -> tuple:
    """The shape of an array, a nested sequence or a tensor on any device."""
    return tuple(A.shape) if hasattr(A, "shape") else np.shape(A)


def host_array(A) -> np.ndarray:
    """``A`` as a numpy array: a torch tensor (on any device) from its host
    copy."""
    if hasattr(A, "detach") and hasattr(A, "cpu"):
        return A.detach().cpu().numpy()
    return np.asarray(A)


# ---------------------------------------------------------------------------
# typed errors — backpressure the client can branch on
# ---------------------------------------------------------------------------


class Overload(RuntimeError):
    """The control plane rejected a request at admission.

    ``reason`` is machine-readable: "queue" (bounded queue full) or
    "quota" (tenant token bucket exhausted).  Raised synchronously from
    ``submit`` — an overloaded server never hands back a future that will
    hang out a timeout."""

    def __init__(self, message: str, *, reason: str, tenant: str | None = None):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before dispatch; delivered through the
    request future (the drop happens queue-side, never mid-solve)."""


# ---------------------------------------------------------------------------
# request specs: WHAT to solve
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseSpec:
    """A single-class request from the dense (p, p) covariance."""

    S: object
    lam: float

    @property
    def p(self) -> int:
        return int(_shape(self.S)[0])


@dataclass(frozen=True)
class DataSpec:
    """A single-class request from the raw (n, p) data matrix: screening
    runs out-of-core (``repro_torch.stream``) — the dense S never exists.

    ``session`` names a pinned screen state for later incremental
    ``append_rows``; ``stream`` is a ``repro_torch.stream.StreamConfig`` (or
    a kwargs dict) for this request."""

    X: object
    lam: float
    session: str | None = None
    stream: object = None

    @property
    def p(self) -> int:
        return int(_shape(self.X)[1])


@dataclass(frozen=True)
class JointSpec:
    """A K-class joint request (``repro_torch.joint``): pass ``Ss`` (class
    covariances) or ``Xs`` (per-class data matrices, screened out-of-core),
    never both."""

    Ss: object = None
    lam1: float = 0.0
    lam2: float = 0.0
    penalty: str = "group"
    Xs: object = None
    stream: object = None

    def __post_init__(self):
        if (self.Ss is None) == (self.Xs is None):
            raise ValueError("JointSpec needs exactly one of Ss or Xs")

    @property
    def K(self) -> int:
        mats = self.Ss if self.Ss is not None else self.Xs
        return len(mats)

    @property
    def p(self) -> int:
        if self.Ss is not None:
            return int(_shape(self.Ss[0])[0])
        return int(_shape(self.Xs[0])[1])


#: Criteria a ``PathSpec`` may name — mirrors ``repro_torch.select.CRITERIA``
#: (kept literal here so the control plane stays engine-import-free).
PATH_CRITERIA = ("ebic", "cv", "stars")


@dataclass(frozen=True)
class PathSpec:
    """A model-selection request: solve a descending lambda path (warm
    homotopy, ``repro_torch.select``) and return the criterion-selected graph
    plus per-lambda diagnostics (a ``select.Selection``).

    ``grid`` is an explicit sequence of lambdas, ``{"auto": n_points}`` or
    a bare int (auto grid anchored at lambda_max), or None (auto, 20
    points).  ``criterion`` is one of ``PATH_CRITERIA``; "cv" and "stars"
    resample rows and therefore require the data-matrix form (``X=``).
    ``n`` is the sample count EBIC needs when only the covariance ``S`` is
    given; ``criterion_opts`` forwards criterion knobs (cv ``k``, stars
    ``n_subsamples``/``beta``, ...).  Path requests default to the "batch"
    SLO at admission — a whole grid of solves should not jump interactive
    co-travellers — and never take the admission fast path."""

    S: object = None
    X: object = None
    grid: object = None
    criterion: str = "ebic"
    n: int | None = None
    gamma: float = 0.5
    criterion_opts: object = None
    stream: object = None

    def __post_init__(self):
        if (self.S is None) == (self.X is None):
            raise ValueError("PathSpec needs exactly one of S or X")
        if self.criterion not in PATH_CRITERIA:
            raise ValueError(
                f"criterion must be one of {PATH_CRITERIA}, "
                f"got {self.criterion!r}"
            )
        if self.criterion in ("cv", "stars") and self.X is None:
            raise ValueError(
                f"criterion {self.criterion!r} resamples rows and needs "
                "the data-matrix form (X=)"
            )

    @property
    def p(self) -> int:
        if self.S is not None:
            return int(_shape(self.S)[0])
        return int(_shape(self.X)[1])


SolveSpec = DenseSpec | DataSpec | JointSpec | PathSpec


# ---------------------------------------------------------------------------
# request meta: HOW to treat it
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestMeta:
    """Per-request serving policy; orthogonal to the spec.

    ``deadline`` is RELATIVE seconds from admission (converted to an
    absolute monotonic instant inside the server); ``output`` overrides the
    server-level representation ("dense" | "sparse" | "auto")."""

    tenant: str = "default"
    slo: str = "interactive"
    deadline: float | None = None
    output: str | None = None

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"slo must be one of {SLO_CLASSES}, got {self.slo!r}"
            )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("deadline must be positive seconds")


# ---------------------------------------------------------------------------
# per-tenant token buckets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Quota:
    """Tenant admission budget: ``rate`` requests/second refill, ``burst``
    bucket capacity (momentary spike allowance)."""

    rate: float
    burst: float

    def __post_init__(self):
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError("quota rate and burst must be positive")


class TokenBucket:
    """Classic token bucket; thread-safe; clock injectable for tests."""

    def __init__(self, quota: Quota, *, clock=time.monotonic):
        self.quota = quota
        self._clock = clock
        self._tokens = float(quota.burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.quota.burst,
                self._tokens + (now - self._stamp) * self.quota.rate,
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(
                self.quota.burst,
                self._tokens + (now - self._stamp) * self.quota.rate,
            )


# ---------------------------------------------------------------------------
# bounded two-class priority queue
# ---------------------------------------------------------------------------


class AdmissionQueue:
    """Bounded dispatch queue with two strict priority levels.

    "interactive" items dequeue before any "batch" item (FIFO within a
    level) — the priority half of the SLO contract; the bounded half is
    ``try_put`` returning False when ``maxsize`` items are already waiting,
    which the server surfaces as a typed ``Overload``.  API mirrors the
    ``queue.Queue`` subset the batcher uses (``get(timeout)`` raising
    ``queue.Empty``, ``get_nowait``) so the drain loop is unchanged."""

    def __init__(self, maxsize: int = 0):
        self.maxsize = int(maxsize)  # 0 = unbounded (legacy behavior)
        self._interactive: deque = deque()
        self._batch: deque = deque()
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._interactive) + len(self._batch)

    def try_put(self, item, *, slo: str = "interactive") -> bool:
        with self._cond:
            if self.maxsize > 0 and (
                len(self._interactive) + len(self._batch) >= self.maxsize
            ):
                return False
            (self._interactive if slo == "interactive" else self._batch).append(
                item
            )
            self._cond.notify()
            return True

    def _pop_locked(self):
        if self._interactive:
            return self._interactive.popleft()
        return self._batch.popleft()

    def get(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not (self._interactive or self._batch):
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)
            return self._pop_locked()

    def get_nowait(self):
        with self._cond:
            if not (self._interactive or self._batch):
                raise queue.Empty
            return self._pop_locked()


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------


def fingerprint_array(A) -> str:
    """Content hash of one array: sha1 over (shape, dtype, C-contiguous
    bytes) — the cache-key primitive for spec payloads (a tensor hashes as
    its host copy, so it keys as the same numpy array)."""
    A = np.ascontiguousarray(host_array(A))
    h = hashlib.sha1()
    h.update(str(A.shape).encode())
    h.update(str(A.dtype).encode())
    h.update(A.tobytes())
    return h.hexdigest()


def _grid_key(grid) -> tuple | None:
    """Hashable form of a PathSpec grid — None = uncacheable spelling.
    Distinct spellings of the same auto grid (None vs {"auto": 20}) key
    differently; that only costs a cache miss, never a wrong hit."""
    if grid is None:
        return ("auto", None)
    if isinstance(grid, (int, np.integer)):
        return ("auto", int(grid))
    if isinstance(grid, dict):
        if set(grid) != {"auto"}:
            return None
        return ("auto", int(grid["auto"]))
    try:
        return ("grid",) + tuple(
            float(v) for v in np.asarray(list(grid), dtype=float).ravel()
        )
    except (TypeError, ValueError):
        return None


def _opts_key(opts) -> tuple | None:
    """Hashable form of criterion_opts — None = uncacheable (non-primitive
    values)."""
    if opts is None:
        return ()
    try:
        items = tuple(sorted((str(k), v) for k, v in dict(opts).items()))
        hash(items)
        return items
    except (TypeError, ValueError):
        return None


def spec_cache_key(spec, output: str) -> tuple | None:
    """Hashable cache key for a spec + resolved output — or None when the
    request is uncacheable (named sessions mutate; custom stream configs
    may reorder float accumulation, so only the default tiling caches).
    Path requests key on (payload fingerprint, grid, criterion + its
    parameters, output)."""
    if isinstance(spec, PathSpec):
        if spec.stream is not None:
            return None
        gk = _grid_key(spec.grid)
        ok = _opts_key(spec.criterion_opts)
        if gk is None or ok is None:
            return None
        payload = spec.S if spec.S is not None else spec.X
        return (
            "path" if spec.S is not None else "path_data",
            fingerprint_array(payload),
            gk,
            spec.criterion,
            None if spec.n is None else int(spec.n),
            float(spec.gamma),
            ok,
            output,
        )
    if isinstance(spec, DenseSpec):
        return ("dense", fingerprint_array(spec.S), float(spec.lam), output)
    if isinstance(spec, DataSpec):
        if spec.session is not None or spec.stream is not None:
            return None
        return ("data", fingerprint_array(spec.X), float(spec.lam), output)
    if isinstance(spec, JointSpec):
        if spec.stream is not None:
            return None
        mats = spec.Ss if spec.Ss is not None else spec.Xs
        kind = "joint" if spec.Ss is not None else "joint_data"
        return (
            kind,
            tuple(fingerprint_array(M) for M in mats),
            float(spec.lam1),
            float(spec.lam2),
            spec.penalty,
            len(mats),
            output,
        )
    return None


class ResultCache:
    """Thread-safe LRU over finished results, keyed by ``spec_cache_key``.

    A hit returns the finished ``GlassoResult`` without touching the
    screen, the planner or the card."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        if key is None or self.maxsize <= 0:
            return None
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key, value) -> None:
        if key is None or self.maxsize <= 0 or value is None:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


# ---------------------------------------------------------------------------
# deadline helper
# ---------------------------------------------------------------------------


def deadline_instant(meta: RequestMeta | None) -> float | None:
    """Absolute monotonic expiry for a request admitted NOW (None = never)."""
    if meta is None or meta.deadline is None:
        return None
    return time.monotonic() + float(meta.deadline)


@dataclass
class TenantBuckets:
    """Per-tenant bucket registry: ``quotas`` maps tenant -> Quota;
    ``default`` applies to unlisted tenants (None = unmetered)."""

    quotas: dict = field(default_factory=dict)
    default: Quota | None = None
    clock: object = time.monotonic

    def __post_init__(self):
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def try_admit(self, tenant: str) -> bool:
        quota = self.quotas.get(tenant, self.default)
        if quota is None:
            return True
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None or bucket.quota != quota:
                bucket = self._buckets[tenant] = TokenBucket(
                    quota, clock=self.clock
                )
        return bucket.try_acquire()
