"""Request-scoped span tracer with explicit cross-thread propagation.

One ``submit(spec)`` fans out across the admission thread, the serving
batcher, the executor's dispatch waves, and (for joint/select work) whole
sub-engines.  The tracer answers "where did THIS request's 80 ms go"
without a benchmark rerun: every stage opens a ``span(...)`` context
manager, the spans nest into a per-request :class:`Trace`, and the trace
travels on the result (``GlassoResult.trace``) and on serve futures.

Propagation rules (DESIGN.md Section 17):

* The ambient context is a ``contextvars.ContextVar`` holding
  ``(trace, active_span_id)``.  ``span()`` is a NO-OP when nothing is
  active — untraced code paths pay one ContextVar read.
* Crossing a thread pool is EXPLICIT: the enqueuing side captures
  ``context_token()`` and the worker wraps its portion in
  ``activate(token)``.  contextvars do not flow into pre-started worker
  threads on their own, and implicit inheritance would mis-attribute
  batcher work to whichever request started the thread.
* ``trace_request()`` starts a new trace ONLY when none is active;
  otherwise it degrades to a plain child span, so a serving-owned
  request trace absorbs the engine's own ``engine.run`` tree instead of
  forking a second root.

All timestamps come from ``time.perf_counter()`` — monotonic, so span
durations never go negative across wall-clock adjustments (the ruff
TID251 gate bans the wall clock in ``src/`` for exactly this reason).
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = [
    "Span",
    "Trace",
    "trace_request",
    "span",
    "current_trace",
    "context_token",
    "activate",
]

_CURRENT: contextvars.ContextVar[tuple["Trace", int] | None] = (
    contextvars.ContextVar("repro_torch_obs_current", default=None)
)


@dataclass
class Span:
    """One timed stage.  ``t0``/``t1`` are perf_counter instants; ``t1``
    is None while the span is open."""

    name: str
    span_id: int
    parent_id: int | None
    t0: float
    t1: float | None = None
    attrs: dict[str, Any] = field(default_factory=dict)
    thread: str = ""

    @property
    def seconds(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return max(0.0, end - self.t0)


class Trace:
    """A tree of spans for one request.  Thread-safe: worker threads
    append concurrently under ``activate(token)``."""

    def __init__(self, name: str, **attrs: Any):
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        self._next_id = 0
        self.root_id = self.begin(name, parent_id=None, **attrs)

    # -- recording --------------------------------------------------------

    def begin(self, name: str, *, parent_id: int | None, **attrs: Any) -> int:
        t0 = time.perf_counter()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            self.spans.append(
                Span(
                    name=name,
                    span_id=span_id,
                    parent_id=parent_id,
                    t0=t0,
                    attrs=dict(attrs),
                    thread=threading.current_thread().name,
                )
            )
        return span_id

    def end(self, span_id: int) -> None:
        t1 = time.perf_counter()
        with self._lock:
            sp = self.spans[span_id]
            if sp.t1 is None:
                sp.t1 = t1

    def finish(self) -> "Trace":
        """Close the root span (idempotent).  Open descendants are closed
        at the same instant so exports never contain dangling spans."""
        t1 = time.perf_counter()
        with self._lock:
            for sp in self.spans:
                if sp.t1 is None:
                    sp.t1 = t1
        return self

    # -- views ------------------------------------------------------------

    @property
    def root(self) -> Span:
        return self.spans[self.root_id]

    @property
    def name(self) -> str:
        return self.root.name

    @property
    def wall_seconds(self) -> float:
        return self.root.seconds

    def children(self, span_id: int) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.parent_id == span_id]

    def stage_seconds(self) -> dict[str, float]:
        """Wall seconds of the root's DIRECT children, summed per span
        name — the "where did the time go" one-liner.  Nested detail
        (per-wave dispatch, per-bucket solves) stays in ``spans``."""
        out: dict[str, float] = {}
        for sp in self.children(self.root_id):
            out[sp.name] = out.get(sp.name, 0.0) + sp.seconds
        return out

    def to_dict(self) -> dict[str, Any]:
        """Compact serializable view (serve_stats / debugging)."""
        with self._lock:
            spans = [
                {
                    "name": s.name,
                    "id": s.span_id,
                    "parent": s.parent_id,
                    "t0_us": round((s.t0 - self.spans[self.root_id].t0) * 1e6, 3),
                    "dur_us": round(s.seconds * 1e6, 3),
                    "thread": s.thread,
                    **({"attrs": s.attrs} if s.attrs else {}),
                }
                for s in self.spans
            ]
        return {
            "name": self.name,
            "wall_seconds": self.wall_seconds,
            "stages": self.stage_seconds(),
            "spans": spans,
        }

    def to_chrome_json(self, path: str | None = None) -> str:
        """Chrome trace-event JSON (open in Perfetto / chrome://tracing).

        Complete ("ph": "X") events with microsecond timestamps relative
        to the root span; one tid per recording thread, named via
        thread_name metadata events."""
        with self._lock:
            spans = list(self.spans)
        t_base = spans[self.root_id].t0
        tids: dict[str, int] = {}
        events: list[dict[str, Any]] = []
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids))
            end = s.t1 if s.t1 is not None else time.perf_counter()
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": (s.t0 - t_base) * 1e6,
                    "dur": max(0.0, end - s.t0) * 1e6,
                    "pid": 1,
                    "tid": tid,
                    "args": dict(s.attrs),
                }
            )
        for thread_name, tid in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": thread_name},
                }
            )
        text = json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


# -- ambient context ------------------------------------------------------


def current_trace() -> Trace | None:
    cur = _CURRENT.get()
    return cur[0] if cur is not None else None


def context_token() -> tuple[Trace, int] | None:
    """Snapshot the active (trace, span) for handoff into a worker
    thread; the worker re-attaches with ``activate(token)``."""
    return _CURRENT.get()


@contextmanager
def activate(token: tuple[Trace, int] | None) -> Iterator[Trace | None]:
    """Re-attach a captured context on the current thread.  ``None`` is
    accepted (and deactivates tracing) so call sites can hand off
    unconditionally."""
    reset = _CURRENT.set(token)
    try:
        yield token[0] if token is not None else None
    finally:
        _CURRENT.reset(reset)


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span | None]:
    """Open a child span under the ambient context; no-op without one."""
    cur = _CURRENT.get()
    if cur is None:
        yield None
        return
    trace, parent_id = cur
    span_id = trace.begin(name, parent_id=parent_id, **attrs)
    reset = _CURRENT.set((trace, span_id))
    try:
        yield trace.spans[span_id]
    finally:
        _CURRENT.reset(reset)
        trace.end(span_id)


@contextmanager
def trace_request(name: str, **attrs: Any) -> Iterator[Trace]:
    """Root a new trace — or, when one is already active, record this
    request as a child span of it (the serving path owns the root)."""
    cur = _CURRENT.get()
    if cur is not None:
        with span(name, **attrs):
            yield cur[0]
        return
    trace = Trace(name, **attrs)
    reset = _CURRENT.set((trace, trace.root_id))
    try:
        yield trace
    finally:
        _CURRENT.reset(reset)
        trace.finish()
