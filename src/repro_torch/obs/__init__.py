"""Observability layer: request-scoped tracing + labeled metrics.

Stdlib copies of the reference package's ``obs`` modules (the port imports
nothing of ``repro``): ``trace`` roots a per-request span tree,
``metrics`` holds the process-global registry behind
``core/instrument.py``'s flat counters.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS_S,
    REGISTRY,
    MetricsRegistry,
    render_prometheus,
)
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    Trace,
    activate,
    context_token,
    current_trace,
    span,
    trace_request,
)

__all__ = [
    "Span",
    "Trace",
    "trace_request",
    "span",
    "current_trace",
    "context_token",
    "activate",
    "MetricsRegistry",
    "REGISTRY",
    "LATENCY_BUCKETS_S",
    "render_prometheus",
]
