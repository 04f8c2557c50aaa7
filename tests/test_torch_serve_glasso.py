"""The port's ``GlassoServer`` (``repro_torch.launch.serve_glasso``) on the
CPU against the reference package's server on the same specs.

Both servers run one options value (the port's ``device="cpu"``, the
kernels' plain versions) on inputs made with numpy from explicit seeds.
Held: labels, route mix and the ``serve.*``, ``joint.*`` and ``stream.*``
counters exactly; Theta within THETA_ATOL = 1e-7 (the solvers run at tol
1e-9 in both packages, and tests/test_torch_path.py shows the port's
bucket solves agree with the reference's lane by lane far inside that);
both results within the reference's ``kkt_residual`` bound; a ``PathSpec``
result bitwise equal to the port's offline ``select_path``.  Coalescing is
checked by calling ``solve_batch`` directly on a fixed list (one dispatch
per (padded size, route), whatever a batching window would catch);
threaded submissions are awaited with ``timeout=`` and checked for their
results only."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.instrument import counts as ref_counts, reset as ref_reset
from repro.core.solvers.kkt import kkt_residual
from repro.engine import EngineOptions as JaxOptions
from repro.launch import control_plane as ref_cp
from repro.launch import serve_glasso as ref_serve
from repro_torch import EngineOptions, glasso
from repro_torch.core.instrument import counts, reset
from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
from repro_torch.launch.control_plane import (
    DataSpec,
    DenseSpec,
    JointSpec,
    PathSpec,
    RequestMeta,
)
from repro_torch.launch.serve_glasso import GlassoRequest, GlassoServer, serve_stats

JAX_TIGHT = JaxOptions(solver_opts={"tol": 1e-9})
TIGHT = EngineOptions.from_reference(dataclasses.asdict(JAX_TIGHT), device="cpu")
THETA_ATOL = 1e-7
KKT_TOL = 1e-5
PREFIXES = ("serve.", "joint.", "stream.")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_both():
    for prefix in PREFIXES + ("router.",):
        ref_reset(prefix.rstrip("."))
        reset(prefix.rstrip("."))


def _assert_same_counters(*prefixes):
    for prefix in prefixes:
        assert counts(prefix) == ref_counts(prefix), prefix


def _kkt(S, Theta, lam):
    return float(kkt_residual(jnp.asarray(S), jnp.asarray(Theta), lam, zero_tol=1e-12))


def _assert_same_result(got, ref, S=None, lam=None):
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.route_mix == ref.route_mix
    np.testing.assert_allclose(got.Theta, np.asarray(ref.Theta), rtol=0, atol=THETA_ATOL)
    if S is not None:
        scale = max(1.0, float(np.abs(S).max()))
        assert _kkt(S, got.Theta, lam) <= KKT_TOL * scale
        assert _kkt(S, np.asarray(ref.Theta), lam) <= KKT_TOL * scale


def _dense_request(seed):
    S = paper_synthetic(3, 8, seed=seed)
    lam_min, lam_max = lambda_interval_for_k(S, 3)
    return S, float(0.4 * lam_min + 0.6 * lam_max)


def _tree_request(seed, p=12, lam=0.3):
    """Tridiagonal S: one path-graph component, a pure closed-form plan."""
    rng = np.random.default_rng(seed)
    S = np.eye(p) * 2.0
    for i in range(p - 1):
        v = rng.uniform(0.5, 0.8) * (1 if rng.random() < 0.5 else -1)
        S[i, i + 1] = S[i + 1, i] = v
    return S, lam


def _mixed_requests():
    """Eight requests: dense three-block covariances (iterative, and a
    block may classify chordal or tree at its lambda) and tridiagonal ones
    (closed form), two sizes of each."""
    reqs = [_dense_request(100 + i) for i in range(4)]
    reqs += [_tree_request(i, p=8 if i % 2 else 12) for i in range(4)]
    return reqs


@pytest.mark.parametrize("route", [True, False])
def test_solve_batch_matches_reference(route):
    """One synchronous coalesced batch of eight requests in both servers:
    the same dispatches (one per (padded size, route)), the same coalesced
    blocks, and each request's result equal to the reference's."""
    reqs = _mixed_requests()
    server = GlassoServer(options=dataclasses.replace(TIGHT, route=route))
    ref_server = ref_serve.GlassoServer(options=dataclasses.replace(JAX_TIGHT, route=route))
    ours = [GlassoRequest(S=S, lam=lam) for S, lam in reqs]
    theirs = [ref_serve.GlassoRequest(S=S, lam=lam) for S, lam in reqs]
    _reset_both()
    server.solve_batch(ours)
    ref_server.solve_batch(theirs)
    _assert_same_counters("serve.", "router.")
    assert counts("serve.")["serve.dispatches"] < len(reqs)
    assert counts("serve.")["serve.coalesced_blocks"] > 0
    for (S, lam), a, b in zip(reqs, ours, theirs):
        got, ref = a.future.result(timeout=0), b.future.result(timeout=0)
        _assert_same_result(got, ref, S, lam)
        assert got.lam == lam and got.device == "cpu"


def test_route_false_batch_is_one_dispatch_per_size():
    """With routing off, eight 3-block requests of one padded size collapse
    into exactly one dispatch of 24 stacked blocks."""
    reqs = [_dense_request(100 + i) for i in range(8)]
    server = GlassoServer(options=dataclasses.replace(TIGHT, route=False))
    batch = [GlassoRequest(S=S, lam=lam) for S, lam in reqs]
    reset("serve")
    server.solve_batch(batch)
    assert counts("serve.") == {
        "serve.batches": 1, "serve.dispatches": 1, "serve.coalesced_blocks": 24,
    }
    for (S, lam), req in zip(reqs, batch):
        res = req.future.result(timeout=0)
        assert sorted(res.block_sizes) == [8, 8, 8]
        direct = glasso(S, lam, options=dataclasses.replace(TIGHT, route=False))
        np.testing.assert_allclose(res.Theta, direct.Theta, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fast_path", [True, False])
def test_fast_path_on_and_off_match_reference(fast_path):
    """Closed-form requests solve at admission with the fast path on (the
    batcher never runs) and through the batcher with it off; both match
    the reference's server, counters included."""
    reqs = [_tree_request(seed=i) for i in range(3)] + [_dense_request(200)]
    _reset_both()
    with GlassoServer(options=TIGHT, fast_path=fast_path) as server:
        ours = [server.submit(DenseSpec(S, lam)) for S, lam in reqs[:3]]
        results = [f.result(timeout=300) for f in ours]
        mixed = server.submit(DenseSpec(*reqs[3])).result(timeout=300)
    with ref_serve.GlassoServer(options=JAX_TIGHT, fast_path=fast_path) as ref_server:
        theirs = [ref_server.submit(ref_cp.DenseSpec(S, lam)) for S, lam in reqs[:3]]
        ref_results = [f.result(timeout=300) for f in theirs]
        ref_mixed = ref_server.submit(ref_cp.DenseSpec(*reqs[3])).result(timeout=300)
    for (S, lam), got, ref in zip(reqs, results + [mixed], ref_results + [ref_mixed]):
        _assert_same_result(got, ref, S, lam)
    st = counts("serve.")
    assert st.get("serve.fastpath_requests", 0) == (3 if fast_path else 0)
    assert st.get("serve.fastpath_requests", 0) == ref_counts("serve.").get(
        "serve.fastpath_requests", 0
    )
    assert st["serve.requests"] == 4 and st.get("serve.fastpath_blocks", 0) >= 3


def test_concurrent_submissions_from_four_threads():
    """Four client threads submit at once (the fast path on the callers'
    threads, the rest on the batcher): every result equals its direct
    solve."""
    reqs = _mixed_requests()
    results: dict[int, object] = {}
    errors: list[BaseException] = []
    with GlassoServer(options=TIGHT, max_delay=0.01) as server:
        def client(k):
            try:
                futs = [(i, server.submit(DenseSpec(*reqs[i]))) for i in range(k, len(reqs), 4)]
                for i, f in futs:
                    results[i] = f.result(timeout=300)
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and sorted(results) == list(range(len(reqs)))
    for i, (S, lam) in enumerate(reqs):
        direct = glasso(S, lam, options=TIGHT)
        np.testing.assert_allclose(results[i].Theta, direct.Theta, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(results[i].labels, direct.labels)


def _session_data(seed=0, n=40, p=64):
    rng = np.random.default_rng(seed)
    scales = np.where(np.arange(p) < 24, 1.0, 0.05)
    X = rng.standard_normal((n, p)) * scales
    Xc = X - X.mean(axis=0)
    S = Xc.T @ Xc / n
    vals = np.unique(np.abs(S[np.triu_indices(p, 1)]))
    k = int(0.95 * (vals.size - 1))  # one general block of 24: a fast plain solve
    lam = float(0.5 * (vals[k] + vals[k + 1]))
    Y = 0.02 * rng.standard_normal((3, p)) * scales
    return X, lam, Y


def test_data_session_and_append_rows_match_reference():
    """A ``DataSpec`` under a session, then ``append_rows``: labels, route
    mix, Theta and the serve/stream counters as in the reference; the
    appended solve matches a dense solve of the stacked data."""
    X, lam, Y = _session_data()
    stream = {"tile": 16, "chunk": 16}
    _reset_both()
    with GlassoServer(options=TIGHT) as server:
        first = server.submit(DataSpec(X, lam, session="s0", stream=stream)).result(timeout=300)
        upd = server.append_rows("s0", Y).result(timeout=300)
        with pytest.raises(KeyError, match="unknown data session"):
            server.append_rows("nope", Y)
    with ref_serve.GlassoServer(options=JAX_TIGHT) as ref_server:
        ref_first = ref_server.submit(
            ref_cp.DataSpec(X, lam, session="s0", stream=stream)
        ).result(timeout=300)
        ref_upd = ref_server.append_rows("s0", Y).result(timeout=300)
    _assert_same_result(first, ref_first)
    _assert_same_result(upd, ref_upd)
    _assert_same_counters("serve.", "stream.")
    assert counts("stream.")["stream.tiles_revalidated"] > 0
    X2 = np.vstack([X, Y])
    Xc = X2 - X2.mean(axis=0)
    S2 = Xc.T @ Xc / X2.shape[0]
    direct = glasso(S2, lam, options=TIGHT)
    np.testing.assert_allclose(upd.Theta, direct.Theta, rtol=0, atol=1e-5)
    assert _kkt(S2, upd.Theta, lam) <= KKT_TOL * max(1.0, float(np.abs(S2).max()))
    st = serve_stats()
    assert "stream.tiles_revalidated" in st and "serve.session_updates" in st


def _joint_classes(rng, class_specific):
    p = 16
    Ss = [np.eye(p) * 2.0 for _ in range(3)]
    for k in range(3):
        for i, j, v in [(0, 1, 0.9), (1, 2, -0.8), (2, 3, 0.7)]:
            Ss[k][i, j] = Ss[k][j, i] = v
    if class_specific:
        blk = rng.standard_normal((24, 5))
        for k in range(3):
            Ss[k][np.ix_(range(6, 11), range(6, 11))] = (
                blk.T @ blk / 24 + (2 + 0.3 * k) * np.eye(5) + 0.6 * (1 - np.eye(5))
            )
    return Ss


@pytest.mark.parametrize("class_specific,penalty", [(False, "fused"), (True, "group")])
def test_joint_requests_match_reference(class_specific, penalty):
    """An identical-block forest plan solves at admission; class-specific
    blocks queue for the joint ADMM.  Both as in the reference's server:
    labels, route mix, Theta, and the joint/serve counters."""
    Ss = _joint_classes(np.random.default_rng(7), class_specific)
    _reset_both()
    with GlassoServer(options=TIGHT) as server:
        got = server.submit(JointSpec(Ss=Ss, lam1=0.4, lam2=0.1, penalty=penalty)).result(
            timeout=300
        )
    with ref_serve.GlassoServer(options=JAX_TIGHT) as ref_server:
        ref = ref_server.submit(
            ref_cp.JointSpec(Ss=Ss, lam1=0.4, lam2=0.1, penalty=penalty)
        ).result(timeout=300)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.route_mix == ref.route_mix
    np.testing.assert_allclose(got.Theta, np.asarray(ref.Theta), rtol=0, atol=THETA_ATOL)
    _assert_same_counters("joint.", "serve.")
    assert counts("joint.").get("joint.fastpath_requests", 0) == int(not class_specific)
    if class_specific:
        assert got.route_mix.get("joint_general", 0) >= 1


def test_pathspec_bitwise_equals_offline_select_path():
    """A served ``PathSpec`` is ``select_path`` itself: scores, selection,
    lambdas and every Theta block bit for bit; the second submit is a
    result-cache hit."""
    from repro_torch.select import select_path

    rng = np.random.default_rng(1)
    p = 14
    X = rng.standard_normal((2 * p + 8, p)) @ (np.eye(p) + 0.3 * rng.standard_normal((p, p)))
    S = np.cov(X, rowvar=False, bias=True)
    vals = np.unique(np.abs(S[np.triu_indices(p, 1)]))
    grid = [float(0.5 * (vals[k] + vals[k + 1])) for k in (int(q * (vals.size - 2))
                                                             for q in (0.8, 0.5, 0.3))]
    opts = dataclasses.replace(TIGHT, output="sparse")
    offline = select_path(S, grid=grid, criterion="ebic", n=120, options=opts)
    spec = PathSpec(S=S, grid=grid, criterion="ebic", n=120)
    reset("serve")
    with GlassoServer(options=opts, result_cache=4) as server:
        served = server.submit(spec).result(timeout=300)
        again = server.submit(spec).result(timeout=300)
    assert served.report.scores == offline.report.scores
    assert served.report.selected_index == offline.report.selected_index
    assert served.report.lambdas == offline.report.lambdas
    np.testing.assert_array_equal(served.result.support_edges(), offline.result.support_edges())
    for (ca, ba), (cb, bb) in zip(served.result.Theta.blocks(), offline.result.Theta.blocks()):
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(ba, bb)
    assert again is served
    st = counts("serve.")
    assert st["serve.path_requests"] == 1 and st["serve.cache.hits"] == 1


def test_oversize_request_takes_the_sharded_route_as_in_reference():
    """A component past ``oversize_threshold`` is admitted and solved down
    the sharded route by the batcher (never at admission), as in the
    reference: labels, route mix, per-request oversize accounting, Theta."""
    S, lam = _dense_request(300)
    jopts = dataclasses.replace(JAX_TIGHT, oversize_threshold=6)
    _reset_both()
    with GlassoServer(options=dataclasses.replace(TIGHT, oversize_threshold=6)) as server:
        got = server.submit(DenseSpec(S, lam)).result(timeout=300)
    with ref_serve.GlassoServer(options=jopts) as ref_server:
        ref = ref_server.submit(ref_cp.DenseSpec(S, lam)).result(timeout=300)
    _assert_same_result(got, ref, S, lam)
    assert got.route_mix.get("oversize", 0) == 3
    assert got.oversize["dispatched"] == ref.oversize["dispatched"] == 3
    assert got.oversize["fallbacks"] == ref.oversize["fallbacks"]
    _assert_same_counters("serve.")
    assert counts("serve.").get("serve.fastpath_requests", 0) == 0


def test_stop_fails_inflight_data_and_joint_requests():
    """Shutdown with queued data-session and joint requests fails every
    future cleanly; post-stop admissions of every kind fail fast."""
    rng = np.random.default_rng(2)
    p = 32
    X = rng.standard_normal((40, p)) * (0.1 + rng.random(p))
    Ss = [np.eye(8) + 0.6 * (1 - np.eye(8)) * (0.9 ** k) for k in range(2)]
    server = GlassoServer(options=TIGHT, fast_path=False)
    f_data = server.submit(DataSpec(X, 0.05, session="s-stop", stream={"tile": 16, "chunk": 8}))
    f_joint = server.submit(JointSpec(Ss=Ss, lam1=0.3, lam2=0.05, penalty="group"))
    f_path = server.submit(PathSpec(S=Ss[0], grid=[0.5, 0.3], n=20))
    assert not any(f.done() for f in (f_data, f_joint, f_path))
    server.stop()
    for fut in (f_data, f_joint, f_path):
        with pytest.raises(RuntimeError, match="GlassoServer stopped"):
            fut.result(timeout=5)
    for spec in (DenseSpec(np.eye(4), 0.5), DataSpec(X, 0.05),
                 JointSpec(Ss=Ss, lam1=0.3, lam2=0.05)):
        with pytest.raises(RuntimeError, match="GlassoServer stopped"):
            server.submit(spec).result(timeout=5)


def test_metrics_trace_and_serve_stats():
    """The observability surface: the latency histogram per kind in
    ``metrics()``, a request trace on the future and the result, and
    ``serve_stats`` over every namespace (``kernels.*`` stays at zero on
    the CPU's plain path)."""
    from repro_torch.obs.metrics import REGISTRY

    S, lam = _dense_request(400)
    reset("kernels")
    with GlassoServer(options=TIGHT) as server:
        fut = server.submit(DenseSpec(S, lam), meta=RequestMeta(tenant="t-obs"))
        res = fut.result(timeout=300)
        text = server.metrics()
    assert 'serve_request_seconds_count{kind="dense",slo="interactive",tenant="t-obs"} 1' in text
    assert REGISTRY.quantile("serve.request_seconds", 0.5, tenant="t-obs") > 0
    assert fut.trace is res.trace and res.trace is not None
    assert "serve.plan" in res.trace.stage_seconds()
    st = serve_stats()
    assert st["serve.requests"] >= 1
    assert not any(k.startswith("kernels.") and v for k, v in st.items())


def test_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve_glasso import main

    main(["--requests", "4", "--p", "20", "--blocks", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "serve counters:" in out and "kernel launches:" in out
