"""Labeled metrics registry: counters, gauges, log-bucketed histograms.

Two surfaces share one store:

* **Flat dotted counters** — the historical ``core/instrument.py``
  namespace (``serve.requests``, ``engine.dispatch.us``, watermarks).
  ``instrument`` is now a thin shim over this registry, so every
  pre-existing counter name, ``tail_counts`` view, and benchmark gate
  keeps working bitwise.  Values may accumulate as floats internally
  (the dispatch-µs fix); the read surface rounds to int.
* **Labeled families** — ``inc``/``set_gauge``/``observe`` keyed by
  ``(name, sorted label items)``.  Label taxonomy (DESIGN.md §17):
  ``tenant``, ``slo``, ``route``, ``kind``.  Histograms use fixed
  log-spaced latency buckets so the server itself reports p50/p99 per
  tenant/SLO class without client cooperation.

``reset(prefix)`` clears BOTH stores by dotted-name prefix — the serving
benchmark's ``reset("serve")`` between warmup and the measured loop
therefore also zeroes the ``serve.request_seconds`` histogram.

``render_prometheus()`` emits text exposition format (the ``/metrics``
surface); dotted names are sanitized to underscores per the Prometheus
data model.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Iterable

__all__ = [
    "MetricsRegistry",
    "REGISTRY",
    "LATENCY_BUCKETS_S",
    "render_prometheus",
]

#: 40 log-spaced bucket upper bounds, 100 µs .. ~1100 s (ratio 1.5), plus
#: +Inf implicitly.  Quantile estimates are therefore exact to a factor
#: of 1.5 anywhere in the serving latency range.
LATENCY_BUCKETS_S: tuple[float, ...] = tuple(1e-4 * 1.5**k for k in range(40))

_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last slot = +Inf
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = bisect_left(self.buckets, value)
        self.counts[i] += 1
        self.total += 1
        self.sum += value


class MetricsRegistry:
    """Thread-safe; one process-global instance (``REGISTRY``) below."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flat: dict[str, float] = {}
        # name -> {"type": ..., "series": {label_key: value|_Histogram},
        #          "buckets": ...}
        self._families: dict[str, dict[str, Any]] = {}

    # -- flat dotted counters (instrument.py backing store) ---------------

    def bump_flat(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._flat[name] = self._flat.get(name, 0) + n

    def set_peak_flat(self, name: str, value: float) -> None:
        with self._lock:
            if value > self._flat.get(name, 0):
                self._flat[name] = value

    def flat_value(self, name: str) -> float:
        with self._lock:
            return self._flat.get(name, 0)

    def flat_items(self, prefix: str = "") -> dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._flat.items() if k.startswith(prefix)}

    # -- labeled families -------------------------------------------------

    def _family(self, name: str, kind: str, buckets=None) -> dict[str, Any]:
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": kind, "series": {}, "buckets": buckets}
            self._families[name] = fam
        elif fam["type"] != kind:
            raise TypeError(
                f"metric {name!r} already registered as {fam['type']}, "
                f"not {kind}"
            )
        return fam

    def inc(self, name: str, n: float = 1, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "counter")
            fam["series"][key] = fam["series"].get(key, 0) + n

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "gauge")
            fam["series"][key] = value

    def observe(
        self,
        name: str,
        value: float,
        *,
        buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
        **labels: Any,
    ) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "histogram", buckets)
            hist = fam["series"].get(key)
            if hist is None:
                hist = fam["series"][key] = _Histogram(fam["buckets"])
            hist.observe(value)

    def value(self, name: str, **labels: Any) -> float:
        """Current value of one counter/gauge series (0 if absent)."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] == "histogram":
                return 0.0
            return float(fam["series"].get(key, 0))

    def histogram_totals(self, name: str, **labels: Any) -> dict[str, float]:
        """Merged count/sum over every series whose labels are a superset
        of ``labels`` (sum-less-precise view of ``quantile``)."""
        want = set(_label_key(labels))
        total, s = 0, 0.0
        with self._lock:
            fam = self._families.get(name)
            if fam is not None and fam["type"] == "histogram":
                for key, hist in fam["series"].items():
                    if want.issubset(set(key)):
                        total += hist.total
                        s += hist.sum
        return {"count": total, "sum": s}

    def quantile(self, name: str, q: float, **labels: Any) -> float:
        """Estimated q-quantile of a histogram, merging every series whose
        labels are a superset of ``labels`` — e.g.
        ``quantile("serve.request_seconds", 0.99, tenant="web",
        slo="interactive")`` merges over ``kind``.  Returns the upper
        bound of the bucket holding the target rank (NaN when empty), so
        estimates are conservative to one bucket ratio (1.5x)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        want = set(_label_key(labels))
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] != "histogram":
                return float("nan")
            buckets = fam["buckets"]
            merged = [0] * (len(buckets) + 1)
            total = 0
            for key, hist in fam["series"].items():
                if want.issubset(set(key)):
                    for i, c in enumerate(hist.counts):
                        merged[i] += c
                    total += hist.total
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0
        for i, c in enumerate(merged):
            cum += c
            if cum >= rank and c:
                return buckets[i] if i < len(buckets) else float("inf")
        return float("inf")

    # -- lifecycle --------------------------------------------------------

    def reset(self, prefix: str = "") -> None:
        with self._lock:
            for k in [k for k in self._flat if k.startswith(prefix)]:
                del self._flat[k]
            for k in [k for k in self._families if k.startswith(prefix)]:
                del self._families[k]

    # -- exposition -------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition: labeled families first (counters,
        gauges, histograms with ``_bucket``/``_sum``/``_count``), then the
        flat dotted counters as unlabeled counters."""
        with self._lock:
            lines: list[str] = []
            for name in sorted(self._families):
                fam = self._families[name]
                pname = _sanitize(name)
                lines.append(f"# TYPE {pname} {fam['type']}")
                if fam["type"] == "histogram":
                    for key, hist in sorted(fam["series"].items()):
                        cum = 0
                        bounds = [*fam["buckets"], float("inf")]
                        for bound, c in zip(bounds, hist.counts):
                            cum += c
                            le = "+Inf" if bound == float("inf") else _fmt(bound)
                            lines.append(
                                f"{pname}_bucket{{{_labels(key, le=le)}}} {cum}"
                            )
                        lines.append(
                            f"{pname}_sum{{{_labels(key)}}} {_fmt(hist.sum)}"
                        )
                        lines.append(
                            f"{pname}_count{{{_labels(key)}}} {hist.total}"
                        )
                else:
                    for key, v in sorted(fam["series"].items()):
                        label_part = f"{{{_labels(key)}}}" if key else ""
                        lines.append(f"{pname}{label_part} {_fmt(v)}")
            for name in sorted(self._flat):
                pname = _sanitize(name)
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_fmt(self._flat[name])}")
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _labels(key: Iterable[tuple[str, str]], **extra: str) -> str:
    pairs = [*key, *sorted(extra.items())]
    return ",".join(f'{k}="{v}"' for k, v in pairs)


def _fmt(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


#: The process-global registry every layer records into.
REGISTRY = MetricsRegistry()


def render_prometheus() -> str:
    """Module-level convenience: exposition of the global registry."""
    return REGISTRY.render_prometheus()
