"""The port's observability against the reference's contract, after
``tests/test_obs.py``'s 21 checks: the span tracer (``obs/trace.py``), the
labeled metrics registry (``obs/metrics.py``), the instrument shim
(``core/instrument.py``), ``result.stages()`` and the trace of ``Engine``,
``select_path``'s root trace, and trace isolation under concurrent
``GlassoServer`` traffic, all on the CPU (``EngineOptions(device="cpu")``).
Where the reference accepts ``trace="jax"`` (an annotation of JAX
profiles), the port's options accept it and its ``Engine`` refuses it.
Then the two exports the port adds: ``glasso_forest`` from
``kernels.tree_glasso`` and ``build_model`` from ``models``, under the
reference's names.

The registry is process-global, so registry tests use a ``testobs.``
namespace (and unique tenants in the serving test) to stay independent of
whatever counters other tests have already bumped.
"""

import json
import math
import threading

import numpy as np
import pytest

from repro_torch.core import instrument
from repro_torch.engine.options import EngineOptions
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, REGISTRY, MetricsRegistry
from repro_torch.obs.trace import (
    Trace,
    activate,
    context_token,
    current_trace,
    span,
    trace_request,
)

CPU = EngineOptions(device="cpu")


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_noop_without_context():
    with span("orphan") as sp:
        assert sp is None
    assert current_trace() is None


def test_trace_request_nests_and_finishes():
    with trace_request("req", tenant="t") as tr:
        assert current_trace() is tr
        with span("outer", k=1):
            with span("inner"):
                pass
        with span("outer"):
            pass
    assert current_trace() is None
    assert tr.root.t1 is not None  # finished
    names = [s.name for s in tr.spans]
    assert names == ["req", "outer", "inner", "outer"]
    # nesting: inner's parent is the first outer, outers parent the root
    by_id = {s.span_id: s for s in tr.spans}
    inner = tr.spans[2]
    assert by_id[inner.parent_id].name == "outer"
    assert by_id[by_id[inner.parent_id].parent_id].name == "req"
    # stage view sums DIRECT children per name (two "outer" spans)
    stages = tr.stage_seconds()
    assert set(stages) == {"outer"}
    assert stages["outer"] <= tr.wall_seconds + 1e-9


def test_trace_request_degrades_under_active_trace():
    """Serving owns the root: a nested trace_request must not fork a second
    trace — it records a child span on the active one."""
    with trace_request("serve.request") as outer:
        with trace_request("engine.run") as inner:
            assert inner is outer
    assert [s.name for s in outer.spans] == ["serve.request", "engine.run"]


def test_cross_thread_handoff_explicit():
    """contextvars do not follow threads; the token handoff does."""
    recorded = {}

    def worker(token):
        # a fresh thread sees no ambient context...
        assert current_trace() is None
        with activate(token):
            with span("worker.stage") as sp:
                recorded["thread"] = sp.thread
        assert current_trace() is None

    with trace_request("req") as tr:
        t = threading.Thread(target=worker, args=(context_token(),), name="wk")
        t.start()
        t.join()
    assert [s.name for s in tr.spans] == ["req", "worker.stage"]
    assert recorded["thread"] == "wk"


def test_finish_closes_open_descendants():
    tr = Trace("root")
    child = tr.begin("child", parent_id=tr.root_id)
    tr.finish()
    assert tr.spans[child].t1 is not None
    assert tr.spans[child].t1 <= tr.root.t1 + 1e-12


def test_chrome_export_valid(tmp_path):
    with trace_request("req", tenant="t") as tr:
        with span("a", route="iterative"):
            with span("b"):
                pass
    path = tmp_path / "trace.json"
    text = tr.to_chrome_json(str(path))
    assert path.read_text() == text
    doc = json.loads(text)
    events = doc["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    meta = [e for e in events if e["ph"] == "M"]
    assert len(complete) == 3 and meta, "3 spans + thread_name metadata"
    for e in complete:
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["pid"] == 1
    assert any(e["args"].get("route") == "iterative" for e in complete)
    # to_dict round-trips the same span count
    assert len(tr.to_dict()["spans"]) == 3


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_labels():
    reg = MetricsRegistry()
    reg.inc("testobs.reqs", tenant="a")
    reg.inc("testobs.reqs", 2, tenant="a")
    reg.inc("testobs.reqs", tenant="b")
    reg.set_gauge("testobs.depth", 7, queue="q0")
    assert reg.value("testobs.reqs", tenant="a") == 3
    assert reg.value("testobs.reqs", tenant="b") == 1
    assert reg.value("testobs.reqs", tenant="c") == 0
    assert reg.value("testobs.depth", queue="q0") == 7
    with pytest.raises(TypeError):
        reg.inc("testobs.depth")  # registered as gauge


def test_registry_histogram_quantile_and_merge():
    reg = MetricsRegistry()
    for v in (0.001, 0.002, 0.004, 0.008, 0.2):
        reg.observe("testobs.lat", v, tenant="a", slo="i")
    reg.observe("testobs.lat", 0.5, tenant="b", slo="i")
    # rank 0.5*5 = 2.5 lands on the 3rd sample (0.004); the estimate is
    # that bucket's upper bound — within one 1.5x ratio above the sample
    p50 = reg.quantile("testobs.lat", 0.5, tenant="a")
    assert 0.004 <= p50 <= 0.004 * 1.5
    # label-superset merge: slo="i" pools both tenants
    tot = reg.histogram_totals("testobs.lat", slo="i")
    assert tot["count"] == 6
    assert math.isclose(tot["sum"], 0.715)
    p99 = reg.quantile("testobs.lat", 0.99, slo="i")
    assert 0.5 <= p99 <= 0.5 * 1.5
    # empty selections are NaN, not 0 (0 would read as "fast")
    assert math.isnan(reg.quantile("testobs.lat", 0.5, tenant="zzz"))
    assert math.isnan(reg.quantile("testobs.nope", 0.5))


def test_registry_reset_by_prefix():
    reg = MetricsRegistry()
    reg.bump_flat("testobs.flat", 5)
    reg.bump_flat("other.flat", 5)
    reg.observe("testobs.lat", 0.01)
    reg.reset("testobs")
    assert reg.flat_value("testobs.flat") == 0
    assert reg.flat_value("other.flat") == 5
    assert math.isnan(reg.quantile("testobs.lat", 0.5))


def test_render_prometheus_exposition():
    reg = MetricsRegistry()
    reg.bump_flat("testobs.dotted.counter", 3)
    reg.inc("testobs.reqs", 2, tenant="a")
    reg.observe("testobs.lat", 0.01, slo="i")
    text = reg.render_prometheus()
    assert "# TYPE testobs_reqs counter" in text
    assert 'testobs_reqs{tenant="a"} 2' in text
    assert "# TYPE testobs_lat histogram" in text
    assert 'testobs_lat_count{slo="i"} 1' in text
    assert 'le="+Inf"' in text
    assert "testobs_dotted_counter 3" in text
    # cumulative bucket counts: the +Inf bucket equals the series count
    inf_line = [
        ln for ln in text.splitlines()
        if ln.startswith("testobs_lat_bucket") and 'le="+Inf"' in ln
    ]
    assert inf_line and inf_line[0].endswith(" 1")


def test_latency_buckets_cover_serving_range():
    assert LATENCY_BUCKETS_S[0] == pytest.approx(1e-4)
    assert LATENCY_BUCKETS_S[-1] > 600  # ten minutes fits below +Inf
    ratios = [
        b / a for a, b in zip(LATENCY_BUCKETS_S, LATENCY_BUCKETS_S[1:])
    ]
    assert all(r == pytest.approx(1.5) for r in ratios)


# ---------------------------------------------------------------------------
# instrument shim back-compat + the dispatch-us truncation fix
# ---------------------------------------------------------------------------


def test_timed_dispatch_accumulates_sub_microsecond(monkeypatch):
    """Regression: 10 dispatches of 0.3 us each must read back as 3 us.
    The old per-call int() truncation recorded 0 forever."""
    instrument.reset("engine.dispatch")
    ticks = iter(np.arange(1, 100) * 0.15e-6)
    monkeypatch.setattr(instrument, "_clock", lambda: float(next(ticks)))
    for _ in range(10):
        out, dt = instrument.timed_dispatch(lambda: "ok")
        assert out == "ok"
        assert dt == pytest.approx(0.15e-6)
    assert instrument.count("engine.dispatch.count") == 10
    us = instrument.count("engine.dispatch.us")
    assert isinstance(us, int)
    assert us == 2  # round(10 * 0.15) — truncation would have read 0


def test_instrument_shim_int_reads_and_peaks():
    instrument.reset("testobs")
    instrument.bump("testobs.n")
    instrument.bump("testobs.n", 4)
    instrument.bump("testobs.frac", 0.4)
    instrument.bump("testobs.frac", 0.4)
    instrument.set_peak("testobs.peak", 10)
    instrument.set_peak("testobs.peak", 7)  # watermark keeps the max
    assert instrument.count("testobs.n") == 5
    assert isinstance(instrument.count("testobs.n"), int)
    assert instrument.count("testobs.frac") == 1  # round(0.8)
    assert instrument.counts("testobs.")["testobs.peak"] == 10
    assert instrument.tail_counts("testobs.")["n"] == 5
    instrument.reset("testobs")
    assert instrument.counts("testobs.") == {}


def test_instrument_reset_clears_labeled_families():
    """bench_serve's reset("serve") must zero the request histogram too —
    otherwise warmup latencies leak into the measured quantiles."""
    REGISTRY.observe("serve.request_seconds", 0.123, tenant="testobs-reset")
    assert (
        REGISTRY.histogram_totals(
            "serve.request_seconds", tenant="testobs-reset"
        )["count"]
        == 1
    )
    instrument.reset("serve")
    assert math.isnan(
        REGISTRY.quantile("serve.request_seconds", 0.5, tenant="testobs-reset")
    )


# ---------------------------------------------------------------------------
# engine integration: stages() view, trace attachment, trace=False
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_result():
    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.engine.api import Engine

    S = paper_synthetic(3, 6, seed=3)
    lo, hi = lambda_interval_for_k(S, 3)
    return Engine(options=CPU).run(S, float(0.5 * (lo + hi)))


def test_result_stages_unified_view(small_result):
    r = small_result
    stages = r.stages()
    assert list(stages) == ["screen", "solve", "dispatch", "assemble"]
    # the legacy attributes are views over the same dict
    assert r.screen_seconds == stages["screen"]
    assert r.solve_seconds == stages["solve"]
    assert r.dispatch_seconds == stages["dispatch"]
    assert r.assemble_seconds == stages["assemble"]
    assert r.stages_us == {
        f"{k}_us": int(v * 1e6) for k, v in stages.items()
    }
    # mutating the returned copy must not corrupt the result
    stages["solve"] = -1.0
    assert r.solve_seconds >= 0.0


def test_engine_attaches_trace(small_result):
    tr = small_result.trace
    assert tr is not None and tr.name == "engine.run"
    names = {s.name for s in tr.spans}
    assert {"engine.screen", "engine.plan", "engine.solve"} <= names
    child_sum = sum(sp.seconds for sp in tr.children(tr.root_id))
    assert child_sum <= tr.wall_seconds + 1e-6


def test_trace_false_is_span_free():
    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.engine.api import Engine
    S = paper_synthetic(3, 6, seed=4)
    lo, hi = lambda_interval_for_k(S, 3)
    r = Engine(options=EngineOptions(trace=False, device="cpu")).run(S, float(0.5 * (lo + hi)))
    assert r.trace is None


def test_engine_options_trace_validation():
    from repro_torch.engine.api import Engine

    assert EngineOptions(trace="jax").trace == "jax"
    with pytest.raises(ValueError, match="trace"):
        EngineOptions(trace="chrome")
    # JAX profile annotations have no PyTorch counterpart: the engine refuses
    with pytest.raises(NotImplementedError, match="trace='jax'"):
        Engine(options=EngineOptions(trace="jax", device="cpu"))


def test_select_path_roots_a_trace():
    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.select import select_path

    S = paper_synthetic(2, 5, seed=5)
    lo, hi = lambda_interval_for_k(S, 2)
    sel = select_path(S, grid=[float(hi), float(0.5 * (lo + hi))], n=100, options=CPU)
    tr = sel.result.trace
    assert tr is not None and tr.name == "select.path"
    names = {s.name for s in tr.spans}
    assert {"select.grid", "select.score", "engine.path"} <= names


# ---------------------------------------------------------------------------
# serving: concurrent requests keep disjoint, reconciling span trees
# ---------------------------------------------------------------------------


def test_server_concurrent_trace_isolation():
    """N client threads against ONE server: every result carries its own
    trace, attributed to its own tenant, with every span inside its own
    root window — no cross-request leakage through the shared batcher."""
    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.launch.control_plane import DenseSpec, RequestMeta
    from repro_torch.launch.serve_glasso import GlassoServer

    n_threads = 4
    cases = []
    for i in range(n_threads):
        S = paper_synthetic(3, 6, seed=30 + i)
        lo, hi = lambda_interval_for_k(S, 3)
        cases.append((S, float(0.5 * (lo + hi))))

    results: dict[int, object] = {}
    errors: list[BaseException] = []
    opts = EngineOptions(solver="bcd", solver_opts={"tol": 1e-7}, device="cpu")
    with GlassoServer(options=opts, max_delay=0.002) as server:
        def client(i):
            try:
                S, lam = cases[i]
                meta = RequestMeta(
                    tenant=f"obs-iso-{i}",
                    slo="interactive" if i % 2 == 0 else "batch",
                )
                results[i] = server.submit(DenseSpec(S, lam), meta=meta).result(
                    timeout=300
                )
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not errors, errors

    traces = [results[i].trace for i in range(n_threads)]
    assert all(tr is not None for tr in traces)
    assert len({id(tr) for tr in traces}) == n_threads, "traces were shared"
    for i, tr in enumerate(traces):
        assert tr.root.attrs["tenant"] == f"obs-iso-{i}"
        assert tr.root.attrs["kind"] == "dense"
        assert tr.root.t1 is not None, "request trace never finished"
        for sp in tr.spans:
            assert sp.t0 >= tr.root.t0 - 1e-9, f"{sp.name} precedes the root"
            assert sp.t1 <= tr.root.t1 + 1e-9, f"{sp.name} outlives the root"
        child_sum = sum(sp.seconds for sp in tr.children(tr.root_id))
        assert child_sum <= tr.wall_seconds + 1e-6
        # each request's latency landed in its own labeled series
        assert (
            REGISTRY.histogram_totals(
                "serve.request_seconds", tenant=f"obs-iso-{i}"
            )["count"]
            == 1
        )
    # after the batch resolves, no context may leak into the caller thread
    assert current_trace() is None


def test_server_metrics_surface():
    from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
    from repro_torch.launch.control_plane import DenseSpec, RequestMeta
    from repro_torch.launch.serve_glasso import GlassoServer

    S = paper_synthetic(2, 5, seed=40)
    lo, hi = lambda_interval_for_k(S, 2)
    opts = EngineOptions(solver="bcd", solver_opts={"tol": 1e-7}, device="cpu")
    with GlassoServer(options=opts) as server:
        fut = server.submit(
            DenseSpec(S, float(0.5 * (lo + hi))),
            meta=RequestMeta(tenant="obs-metrics"),
        )
        res = fut.result(timeout=300)
        text = server.metrics()
    # the future carries the trace too (callers without the result object)
    assert fut.trace is res.trace is not None
    assert 'tenant="obs-metrics"' in text
    assert "serve_request_seconds_bucket" in text
    assert "# TYPE serve_request_seconds histogram" in text
    q = REGISTRY.quantile(
        "serve.request_seconds", 0.99, tenant="obs-metrics"
    )
    assert not math.isnan(q) and q > 0


# ---------------------------------------------------------------------------
# the exports the port adds, under the reference's names
# ---------------------------------------------------------------------------


def test_tree_glasso_exports_glasso_forest():
    import repro.kernels.tree_glasso as jax_tree
    import repro_torch.kernels.tree_glasso as tree
    from repro_torch.core.solvers.closed_form import glasso_forest

    assert set(jax_tree.__all__) == set(tree.__all__)
    assert tree.glasso_forest is glasso_forest
    S = np.array([[1.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 1.0]])
    got = tree.glasso_forest(S, 0.1, device="cpu")
    want = np.asarray(jax_tree.glasso_forest(S, 0.1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_models_exports_build_model():
    import repro.models as jax_models
    import repro_torch.models as models
    from repro_torch.models.zoo import build_model

    assert set(jax_models.__all__) == set(models.__all__) == {"build_model"}
    assert models.build_model is build_model
