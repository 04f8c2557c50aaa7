"""The port's serving control plane (``repro_torch.launch.control_plane``)
and the unified ``GlassoServer.submit(spec, meta=...)`` chokepoint on the
CPU: the cases of tests/test_control_plane.py applied to the port's copy
(``lpt_assign``'s priorities among them, on the port's
``core.schedule``), the ``PathSpec`` cases of tests/test_select.py, and
the cache keys of both packages held equal on the same numpy inputs.

Every server here runs ``EngineOptions(device="cpu")`` (the kernels' plain
versions); futures are awaited with a timeout, and no assertion reads a
clock: the one deadline case sleeps well past its deadline before the
batcher starts."""

import dataclasses
import queue as _q
import threading
import time

import numpy as np
import pytest
import torch

from repro.launch import control_plane as ref_cp
from repro_torch import EngineOptions
from repro_torch.launch import control_plane as cp
from repro_torch.core.instrument import count, reset
from repro_torch.covariance import lambda_interval_for_k, paper_synthetic
from repro_torch.launch.control_plane import (
    AdmissionQueue,
    DataSpec,
    DeadlineExceeded,
    DenseSpec,
    JointSpec,
    Overload,
    PathSpec,
    Quota,
    RequestMeta,
    ResultCache,
    TokenBucket,
    spec_cache_key,
)
from repro_torch.launch.serve_glasso import GlassoServer

CPU = EngineOptions(device="cpu", solver_opts={"tol": 1e-8})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_case(seed=0):
    S = paper_synthetic(3, 8, seed=seed)
    lam_min, lam_max = lambda_interval_for_k(S, 3)
    return S, float(0.5 * (lam_min + lam_max))


def _random_cov(seed, p):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((2 * p + 8, p)) @ (np.eye(p) + 0.3 * rng.standard_normal((p, p)))
    return np.cov(X, rowvar=False, bias=True)


# ---------------------------------------------------------------------------
# primitives in isolation
# ---------------------------------------------------------------------------


def test_token_bucket_burst_and_refill():
    now = [0.0]
    b = TokenBucket(Quota(rate=2.0, burst=3.0), clock=lambda: now[0])
    assert all(b.try_acquire() for _ in range(3))
    assert not b.try_acquire()
    now[0] = 1.0
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    now[0] = 100.0
    assert b.tokens == pytest.approx(3.0)


def test_admission_queue_bounded_and_priority():
    q = AdmissionQueue(maxsize=3)
    assert q.try_put("b1", slo="batch")
    assert q.try_put("i1", slo="interactive")
    assert q.try_put("b2", slo="batch")
    assert not q.try_put("i2", slo="interactive")  # full, even for priority
    assert [q.get(timeout=1) for _ in range(3)] == ["i1", "b1", "b2"]
    with pytest.raises(_q.Empty):
        q.get(timeout=0.01)
    q0 = AdmissionQueue(maxsize=0)
    assert all(q0.try_put(i) for i in range(100))
    assert len(q0) == 100


def test_result_cache_lru_eviction():
    c = ResultCache(maxsize=2)
    c.put(("a",), 1)
    c.put(("b",), 2)
    assert c.get(("a",)) == 1
    c.put(("c",), 3)
    assert c.get(("b",)) is None
    assert c.get(("a",)) == 1 and c.get(("c",)) == 3
    assert c.get(None) is None
    c.put(None, 9)
    assert len(c) == 2


def test_spec_cache_keys():
    S, lam = _dense_case()
    k1 = spec_cache_key(DenseSpec(S, lam), "dense")
    k2 = spec_cache_key(DenseSpec(S.copy(), lam), "dense")
    assert k1 == k2
    assert k1 != spec_cache_key(DenseSpec(S, lam * 0.9), "dense")
    assert k1 != spec_cache_key(DenseSpec(S, lam), "sparse")
    # a tensor payload keys as its numpy array
    assert spec_cache_key(DenseSpec(torch.as_tensor(S), lam), "dense") == k1
    X = np.ones((6, 4))
    assert spec_cache_key(DataSpec(X, 0.1), "dense") is not None
    assert spec_cache_key(DataSpec(X, 0.1, session="s"), "dense") is None
    assert spec_cache_key(DataSpec(X, 0.1, stream={"tile": 2}), "dense") is None
    kj = spec_cache_key(JointSpec(Ss=[S, S], lam1=lam, lam2=0.1), "dense")
    assert kj is not None
    assert kj != spec_cache_key(
        JointSpec(Ss=[S, S], lam1=lam, lam2=0.1, penalty="fused"), "dense"
    )


def _specs(mod):
    """The same requests of every kind, built by ``mod``'s spec types."""
    S, lam = _dense_case(seed=4)
    X = np.random.default_rng(3).standard_normal((9, 5))
    return [
        (mod.DenseSpec(S, lam), "dense"),
        (mod.DataSpec(X, 0.2), "sparse"),
        (mod.JointSpec(Ss=[S, 2 * S], lam1=lam, lam2=0.05, penalty="fused"), "dense"),
        (mod.JointSpec(Xs=[X, X + 1.0], lam1=0.3, lam2=0.1), "auto"),
        (mod.PathSpec(S=S, grid={"auto": 7}, criterion="ebic", n=40, gamma=0.25), "sparse"),
        (mod.PathSpec(X=X, grid=[0.5, 0.25], criterion="cv",
                      criterion_opts={"k": 3, "seed": 1}), "dense"),
        (mod.PathSpec(S=S, grid=7), "dense"),
        (mod.PathSpec(S=S), "dense"),
        (mod.DataSpec(X, 0.2, session="s"), "dense"),  # uncacheable: None
    ]


def test_cache_keys_equal_the_reference():
    """For the same numpy inputs, every kind keys exactly as the
    reference's ``spec_cache_key`` (None where it is uncacheable)."""
    for (ours, out), (theirs, _) in zip(_specs(cp), _specs(ref_cp)):
        assert spec_cache_key(ours, out) == ref_cp.spec_cache_key(theirs, out)
        assert ours.p == theirs.p
    a = np.arange(6.0).reshape(2, 3)
    assert cp.fingerprint_array(a) == ref_cp.fingerprint_array(a)


def test_meta_and_spec_validation():
    with pytest.raises(ValueError, match="slo"):
        RequestMeta(slo="realtime")
    with pytest.raises(ValueError, match="deadline"):
        RequestMeta(deadline=0.0)
    with pytest.raises(ValueError, match="exactly one"):
        JointSpec(lam1=0.1)
    with pytest.raises(ValueError, match="exactly one"):
        JointSpec(Ss=[np.eye(2)], Xs=[np.ones((3, 2))], lam1=0.1)
    with pytest.raises(ValueError):
        Quota(rate=0.0, burst=1.0)


def test_pathspec_validation_and_cache_key():
    S = _random_cov(1, 6)
    with pytest.raises(ValueError):
        PathSpec(S=S, X=np.zeros((3, 6)))
    with pytest.raises(ValueError):
        PathSpec()
    with pytest.raises(ValueError):
        PathSpec(S=S, criterion="bic")
    with pytest.raises(ValueError):
        PathSpec(S=S, criterion="cv")
    assert PathSpec(S=S).p == 6
    assert PathSpec(X=np.zeros((4, 9))).p == 9
    k1 = spec_cache_key(PathSpec(S=S, grid={"auto": 5}), "sparse")
    assert k1 == spec_cache_key(PathSpec(S=S, grid={"auto": 5}), "sparse") and k1[0] == "path"
    assert spec_cache_key(PathSpec(S=S, grid=[0.5, 0.2]), "sparse") != k1
    assert spec_cache_key(PathSpec(S=S, grid={"auto": 5}, gamma=1.0), "sparse") != k1
    assert spec_cache_key(PathSpec(S=S, grid={"auto": 5}), "dense") != k1
    assert spec_cache_key(
        PathSpec(X=np.zeros((4, 6)), grid=[0.5], stream={"tile": 4}), "sparse"
    ) is None
    assert GlassoServer._fold_output(None, None, spec=PathSpec(S=S)).slo == "batch"
    assert GlassoServer._fold_output(None, None, spec=DenseSpec(S, 0.5)).slo == "interactive"


def test_lpt_priorities_place_urgent_first():
    from repro.core.schedule import lpt_assign as ref_lpt_assign
    from repro_torch.core.schedule import lpt_assign

    sizes = [4, 4, 4, 4]
    base = lpt_assign(sizes, 2)
    uniform = lpt_assign(sizes, 2, priorities=[1, 1, 1, 1])
    # uniform priorities preserve plain LPT exactly (stable tie-break)
    np.testing.assert_array_equal(base.worker_of, uniform.worker_of)
    # the single urgent equal-cost item is placed first -> worker 0
    urgent = lpt_assign(sizes, 2, priorities=[0, 0, 1, 0])
    assert urgent.worker_of[2] == 0
    np.testing.assert_array_equal(
        urgent.worker_of, ref_lpt_assign(sizes, 2, priorities=[0, 0, 1, 0]).worker_of)
    with pytest.raises(ValueError, match="priorities"):
        lpt_assign(sizes, 2, priorities=[1, 2])


def test_server_without_cuda_raises_unless_cpu():
    """The server solves on the card by default: with no CUDA and no
    ``device="cpu"`` it refuses to start rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GlassoServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GlassoServer(options=EngineOptions())
    GlassoServer(options=EngineOptions(device="cpu")).stop()


# ---------------------------------------------------------------------------
# unified submit: equivalence with the legacy verbs (byte-identical)
# ---------------------------------------------------------------------------


def test_spec_submit_matches_legacy_dense():
    S, lam = _dense_case(seed=3)
    with GlassoServer(options=CPU) as server:
        r_spec = server.submit(DenseSpec(S, lam)).result(timeout=300)
        with pytest.warns(DeprecationWarning, match="submit"):
            r_legacy = server.submit(S, lam).result(timeout=300)
    np.testing.assert_array_equal(r_spec.Theta, r_legacy.Theta)
    np.testing.assert_array_equal(r_spec.labels, r_legacy.labels)
    assert r_spec.solver == r_legacy.solver == "bcd"
    assert r_spec.device == "cpu"


def test_spec_submit_matches_legacy_data():
    rng = np.random.default_rng(0)
    p = 24
    X = rng.standard_normal((40, p)) * (0.1 + rng.random(p))
    lam = 0.08
    with GlassoServer(options=CPU) as server:
        r_spec = server.submit(
            DataSpec(X, lam, stream={"tile": 8, "chunk": 16})
        ).result(timeout=300)
        with pytest.warns(DeprecationWarning, match="submit_data"):
            r_legacy = server.submit_data(
                X, lam, stream={"tile": 8, "chunk": 16}
            ).result(timeout=300)
    np.testing.assert_array_equal(r_spec.Theta, r_legacy.Theta)
    np.testing.assert_array_equal(r_spec.labels, r_legacy.labels)


def test_spec_submit_matches_legacy_joint():
    Ss = [np.eye(8) + 0.6 * (1 - np.eye(8)) * (0.9 ** k) for k in range(2)]
    with GlassoServer(options=CPU) as server:
        r_spec = server.submit(
            JointSpec(Ss=Ss, lam1=0.4, lam2=0.1, penalty="group")
        ).result(timeout=300)
        with pytest.warns(DeprecationWarning, match="submit_joint"):
            r_legacy = server.submit_joint(Ss, 0.4, 0.1, penalty="group").result(timeout=300)
    np.testing.assert_array_equal(r_spec.Theta, r_legacy.Theta)
    assert r_spec.penalty == r_legacy.penalty == "group"


def test_spec_plus_positional_lam_rejected():
    S, lam = _dense_case()
    with GlassoServer(options=CPU) as server:
        with pytest.raises(TypeError, match="spec"):
            server.submit(DenseSpec(S, lam), lam)
        with pytest.raises(TypeError, match="output"):
            server.submit(
                DenseSpec(S, lam), output="dense", meta=RequestMeta(output="sparse")
            )


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_queue_full_raises_typed_overload():
    S, lam = _dense_case()
    reset("serve")
    server = GlassoServer(options=CPU, fast_path=False, max_queue=2)
    f1 = server.submit(DenseSpec(S, lam))
    f2 = server.submit(DenseSpec(S, lam))
    with pytest.raises(Overload) as exc:
        server.submit(DenseSpec(S, lam))
    assert exc.value.reason == "queue"
    assert count("serve.rejected.queue") == 1
    assert not f1.done() and not f2.done()
    server.stop()
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="GlassoServer stopped"):
            f.result(timeout=5)


def test_tenant_quota_isolates_noisy_tenant():
    S, lam = _dense_case()
    reset("serve")
    quotas = {"noisy": Quota(rate=1e-6, burst=2.0)}
    with GlassoServer(options=CPU, quotas=quotas) as server:
        noisy_ok = [
            server.submit(DenseSpec(S, lam), meta=RequestMeta(tenant="noisy"))
            for _ in range(2)
        ]
        with pytest.raises(Overload) as exc:
            server.submit(DenseSpec(S, lam), meta=RequestMeta(tenant="noisy"))
        assert exc.value.reason == "quota" and exc.value.tenant == "noisy"
        quiet = [
            server.submit(DenseSpec(S, lam), meta=RequestMeta(tenant="quiet"))
            for _ in range(4)
        ]
        for f in noisy_ok + quiet:
            assert f.result(timeout=300).Theta is not None
    assert count("serve.rejected.quota") == 1
    assert count("serve.requests") == 6


def test_expired_deadline_never_reaches_solve_batch():
    S, lam = _dense_case()
    reset("serve")
    server = GlassoServer(options=CPU, fast_path=False)
    seen = []
    orig = server.solve_batch
    server.solve_batch = lambda reqs: (seen.extend(reqs), orig(reqs))[1]
    fut = server.submit(DenseSpec(S, lam), meta=RequestMeta(slo="batch", deadline=0.02))
    time.sleep(0.1)
    server.start()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=30)
    server.stop()
    assert seen == []
    assert count("serve.rejected.deadline") == 1


def test_result_cache_hit_skips_planner():
    S, lam = _dense_case(seed=7)
    reset("serve")
    with GlassoServer(options=CPU, result_cache=8) as server:
        r1 = server.submit(DenseSpec(S, lam)).result(timeout=300)
        r2 = server.submit(DenseSpec(S.copy(), lam)).result(timeout=300)
    assert r2 is r1
    assert count("serve.cache.hits") == 1
    assert count("serve.cache.misses") == 1
    assert count("serve.requests") == 2


def test_interactive_slo_keeps_fast_path_batch_slo_queues():
    S, lam = _dense_case()
    lam_hi = float(np.abs(S - np.diag(np.diag(S))).max() * 1.01)  # singletons
    reset("serve")
    with GlassoServer(options=CPU, max_delay=0.01) as server:
        fi = server.submit(DenseSpec(S, lam_hi))
        assert fi.done()  # solved synchronously
        rb = server.submit(DenseSpec(S, lam_hi), meta=RequestMeta(slo="batch")).result(
            timeout=300
        )
    assert count("serve.fastpath_requests") == 1
    np.testing.assert_array_equal(fi.result().Theta, rb.Theta)


def test_concurrent_stop_submit_never_hangs():
    """Submissions racing stop() either solve or fail fast with the
    standard shutdown error — no future is left parked in a drained
    queue."""
    S, lam = _dense_case()
    futures, errors = [], []
    lock = threading.Lock()
    opts = dataclasses.replace(CPU, route=False)
    server = GlassoServer(options=opts, fast_path=False, max_delay=0.001).start()

    def client():
        for _ in range(25):
            try:
                f = server.submit(DenseSpec(S, lam))
                with lock:
                    futures.append(f)
            except Exception as e:  # recorded: none is expected
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    server.stop()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    outcomes = {"ok": 0, "stopped": 0}
    for f in futures:
        try:
            f.result(timeout=30)
            outcomes["ok"] += 1
        except RuntimeError as e:
            assert "GlassoServer stopped" in str(e)
            outcomes["stopped"] += 1
    assert sum(outcomes.values()) == len(futures) == 100
