"""Sparse-native results in the port, mirroring ``tests/test_sparse.py``.

Inside the port, ``output="sparse"`` must give the SAME numbers as
``output="dense"`` bit for bit — one solve, two containers — on every
screening backend, every route rung, the oversize route, dyadic ties, the
joint K-class stack and the from-data path; the global views (COO, CSR,
dense, support) round-trip exactly; the sparse KKT verifiers reproduce the
dense residuals without a (p, p) buffer (the ``result.bytes_peak``
watermark).  Against the reference package: the port's ``SparseTheta``
equals the reference's on the same problem (COO entries and support within
the parity tests' 1e-9 on Theta, ``nnz`` and the index layout exact), and the
large-scale pipeline (``microarray_like`` -> ``covgram`` -> correlation ->
capacity lambda -> device screen -> bcd at p_max) gives the same labels,
route mix and Theta at n = 40, p = 300, p_max = 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import glasso as jax_glasso
from repro.core.partition import lambda_for_max_component as jax_capacity_lambda
from repro.core.sparse import SparseTheta as JaxSparseTheta
from repro.engine import Engine as JaxEngine
from repro.engine import EngineOptions as JaxOptions
from repro.engine import label_components
from repro.kernels.covgram.ops import covgram as jax_covgram
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.components import partitions_equal
from repro_torch.core.partition import lambda_for_max_component
from repro_torch.core.sparse import (
    AUTO_SPARSE_P,
    DENSIFY_MAX_P,
    JointSparseTheta,
    SparseTheta,
    resolve_output,
    result_nbytes,
)
from repro_torch.core.solvers.kkt import kkt_residual_sparse
from repro_torch.covariance import (
    lambda_interval_for_k,
    microarray_like,
    paper_synthetic,
    structured_synthetic,
)
from repro_torch.engine import Engine
from repro_torch.kernels.covgram import covgram

CPU = EngineOptions(device="cpu", solver_opts={"tol": 1e-9})
ATOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(S=None, lam=None, opts=CPU, **kw):
    rs = repro_torch.glasso(S, lam, options=opts.replace(output="sparse"), **kw)
    rd = repro_torch.glasso(S, lam, options=opts.replace(output="dense"), **kw)
    assert isinstance(rs.Theta, SparseTheta) and not isinstance(rd.Theta, SparseTheta)
    assert rs.output == "sparse" and rd.output == "dense"
    return rs, rd


def _assert_bitwise(rs, rd):
    Ts = rs.Theta.toarray()
    assert Ts.dtype == rd.Theta.dtype
    np.testing.assert_array_equal(Ts, rd.Theta)
    np.testing.assert_array_equal(rs.labels, rd.labels)
    assert rs.route_mix == rd.route_mix
    assert rs.Theta.nnz == np.count_nonzero(rd.Theta)
    np.testing.assert_array_equal(rs.support, rd.support)
    np.testing.assert_array_equal(rs.support_edges(), rd.support_edges())


@pytest.mark.parametrize("backend", ["host", "jax", "pallas"])
def test_sparse_equals_dense_all_backends(backend):
    S = paper_synthetic(4, 10, seed=3)
    lam = 0.5 * sum(lambda_interval_for_k(S, 4))
    _assert_bitwise(*_pair(S, lam, CPU.replace(cc_backend=backend)))


@pytest.mark.parametrize("lam", [0.7, 0.45])
def test_sparse_equals_dense_structured_ladder(lam):
    rs, rd = _pair(structured_synthetic(12, 16, seed=1), lam)
    _assert_bitwise(rs, rd)
    if lam == 0.45:
        assert len(set(rs.route_mix) - {"singleton"}) >= 2


@pytest.mark.parametrize("solver", ["pg", "admm"])
def test_sparse_equals_dense_other_solvers(solver):
    _assert_bitwise(*_pair(structured_synthetic(6, 12, seed=2), 0.45, CPU.replace(solver=solver)))


def test_sparse_equals_dense_oversize_route():
    opts = CPU.replace(solver="admm", oversize_threshold=12)
    rs, rd = _pair(structured_synthetic(6, 16, seed=2), 0.4, opts)
    assert rs.oversize["dispatched"] >= 1 and rs.oversize == rd.oversize
    _assert_bitwise(rs, rd)


def test_sparse_exact_on_dyadic_ties():
    S = np.eye(6)
    S[0, 1] = S[1, 0] = 0.5       # == lam: excluded (strict >)
    S[2, 3] = S[3, 2] = 0.75      # > lam: kept
    rs, rd = _pair(S, 0.5)
    _assert_bitwise(rs, rd)
    assert {0, 1} <= set(rs.Theta.isolated.tolist())


def test_sparse_from_data_streamed():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 64))
    X[:, 32:40] += 2.0 * rng.standard_normal((300, 1))  # planted component
    rs = repro_torch.glasso(X=X, lam=0.35, options=CPU.replace(output="sparse"))
    rd = repro_torch.glasso(X=X, lam=0.35, options=CPU.replace(output="dense"))
    _assert_bitwise(rs, rd)
    assert max(len(c) for c in rs.Theta._comps) >= 8


def test_sparse_from_data_deferred_oversize():
    """The oversize component of a from-data solve is deferred to its
    centered columns and gathered at solve time on the sparse path too."""
    rng = np.random.default_rng(8)
    n, p, k = 64, 48, 30
    X = 0.3 * rng.standard_normal((n, p))
    X[:, :k] += rng.standard_normal((n, 1)) * (0.8 + 0.2 * rng.random(k))
    opts = CPU.replace(solver="admm", oversize_threshold=20)
    instrument.reset("stream.")
    rs = repro_torch.glasso(X=X, lam=0.1, options=opts.replace(output="sparse"))
    assert instrument.count("stream.deferred_components") >= 1
    rd = repro_torch.glasso(X=X, lam=0.1, options=opts.replace(output="dense"))
    assert rs.route_mix.get("oversize", 0) >= 1
    _assert_bitwise(rs, rd)


def test_coo_csr_dense_round_trips():
    r = repro_torch.glasso(structured_synthetic(8, 16, seed=4), 0.45,
                           options=CPU.replace(output="sparse"))
    T = r.Theta
    dense = T.toarray()
    rows, cols, vals = T.to_coo()
    back = np.zeros_like(dense)
    back[rows, cols] = vals
    np.testing.assert_array_equal(back, dense)
    assert len(rows) == T.nnz == np.count_nonzero(dense)
    np.testing.assert_array_equal(T.to_csr().toarray(), dense)
    np.testing.assert_array_equal(np.asarray(T), dense)
    np.testing.assert_array_equal(T.diagonal(), np.diagonal(dense))
    idx = np.arange(0, T.p, 7)
    np.testing.assert_array_equal(T.gather_block(idx), dense[np.ix_(idx, idx)])
    np.testing.assert_array_equal(T.diag_at(idx), np.diagonal(dense)[idx])
    assert T.shape == (T.p, T.p) and result_nbytes(T) == T.nbytes() == r.bytes_peak


def test_densify_refusal_above_cap():
    S = paper_synthetic(3, 8, seed=0)
    lam = 0.5 * sum(lambda_interval_for_k(S, 3))
    T = repro_torch.glasso(S, lam, options=CPU.replace(output="sparse")).Theta
    assert T.densify_max == DENSIFY_MAX_P
    T.densify_max = T.p - 1
    with pytest.raises(ValueError, match="refusing to densify"):
        T.toarray()
    with pytest.raises(ValueError, match="refusing to densify"):
        np.asarray(T)
    assert T.toarray(force=True).shape == (T.p, T.p)
    sp_support = T.support()
    assert not isinstance(sp_support, np.ndarray)
    T.densify_max = T.p
    np.testing.assert_array_equal(sp_support.toarray(), T.support())


def test_resolve_output_thresholds():
    assert resolve_output("auto", AUTO_SPARSE_P) == "dense"
    assert resolve_output("auto", AUTO_SPARSE_P + 1) == "sparse"
    assert resolve_output(None, AUTO_SPARSE_P + 1) == "sparse"
    assert resolve_output("dense", 10**6) == "dense"
    assert resolve_output("sparse", 2) == "sparse"
    with pytest.raises(ValueError):
        resolve_output("csv", 10)


def test_kkt_sparse_matches_dense_and_never_densifies():
    from repro_torch.core.solvers.closed_form import kkt_residual_host

    S = structured_synthetic(12, 16, seed=5)
    rs, rd = _pair(S, 0.45)
    instrument.reset("result.")
    res_sparse = kkt_residual_sparse(S, rs.Theta, 0.45)
    res_dense = kkt_residual_host(S, 0.45, rd.Theta)
    assert res_sparse == pytest.approx(res_dense, abs=1e-9)
    peak = instrument.counts("result.")["result.bytes_peak"]
    assert 0 < peak < S.shape[0] ** 2 * 8


def test_joint_kkt_sparse_matches_dense():
    from repro_torch.joint import joint_glasso
    from repro_torch.joint.kkt import joint_kkt_residual, joint_kkt_residual_sparse

    Ss = [paper_synthetic(3, 8, seed=10 + i) for i in range(2)]
    lam1 = 0.5 * sum(lambda_interval_for_k(Ss[0], 3))
    js = joint_glasso(Ss, lam1, 0.05, options=CPU.replace(output="sparse"))
    jd = joint_glasso(Ss, lam1, 0.05, options=CPU.replace(output="dense"))
    instrument.reset("result.")
    res_sparse = joint_kkt_residual_sparse(Ss, js.Theta, lam1, 0.05)
    assert res_sparse == pytest.approx(joint_kkt_residual(Ss, jd.Theta, lam1, 0.05), abs=1e-8)
    p = Ss[0].shape[0]
    assert 0 < instrument.counts("result.")["result.bytes_peak"] < 2 * p * p * 8


@pytest.mark.parametrize("penalty", ["group", "fused"])
def test_joint_sparse_equals_dense(penalty):
    from repro_torch.joint import joint_glasso

    Ss = [paper_synthetic(3, 8, seed=i) for i in range(3)]
    lam1 = 0.5 * sum(lambda_interval_for_k(Ss[0], 3))
    js = joint_glasso(Ss, lam1, 0.05, penalty=penalty, options=CPU.replace(output="sparse"))
    jd = joint_glasso(Ss, lam1, 0.05, penalty=penalty, options=CPU.replace(output="dense"))
    assert isinstance(js.Theta, JointSparseTheta) and js.output == "sparse"
    assert js.K == jd.K == 3 and js.bytes_peak == js.Theta.nbytes() < jd.bytes_peak
    np.testing.assert_array_equal(js.Theta.toarray(), jd.Theta)
    np.testing.assert_array_equal(js.support, jd.support)
    np.testing.assert_array_equal(js.support_edges(), jd.support_edges())
    for k in range(3):
        np.testing.assert_array_equal(js.class_support(k), jd.class_support(k))
        np.testing.assert_array_equal(js.Theta[k].toarray(), jd.Theta[k])


def test_stage_counters_and_bytes_peak():
    S = paper_synthetic(4, 12, seed=6)
    lam = 0.5 * sum(lambda_interval_for_k(S, 4))
    instrument.reset("engine.")
    instrument.reset("result.")
    r = repro_torch.glasso(S, lam, options=CPU.replace(output="sparse"))
    eng = instrument.counts("engine.")
    assert eng.get("engine.solve_us", 0) > 0
    assert "engine.assemble_us" in eng
    assert eng.get("engine.screen_us", 0) > 0
    assert r.assemble_seconds >= 0.0 and r.solve_seconds >= 0.0
    assert r.screen_seconds > 0.0
    assert r.bytes_peak == r.Theta.nbytes() == instrument.counts("result.")["result.bytes_peak"]
    assert r.output == "sparse"
    assert r.bytes_peak < S.shape[0] ** 2 * 8


def test_assemble_dtype_from_S_when_no_buckets():
    from repro_torch.core import blocks as blocks_mod
    from repro_torch.core.screening import thresholded_components
    from repro_torch.engine.planner import build_plan_incremental

    S = np.eye(12, dtype=np.float32)
    labels, _ = thresholded_components(S, 0.5)
    plan, _ = build_plan_incremental(S, 0.5, labels)
    assert not plan.buckets
    Theta = blocks_mod.assemble_dense(plan, [], S)
    sp = blocks_mod.assemble_sparse(plan, [], S)
    assert Theta.dtype == sp.dtype == np.float32
    np.testing.assert_array_equal(sp.toarray(), Theta)


def test_float32_sparse_equals_dense():
    _assert_bitwise(*_pair(structured_synthetic(6, 12, seed=3), 0.5, CPU.replace(dtype="float32")))


def test_blockwise_inverse_sparse():
    from repro_torch.engine.api import blockwise_inverse

    S = paper_synthetic(3, 10, seed=8)
    lam = 0.5 * sum(lambda_interval_for_k(S, 3))
    r = repro_torch.glasso(S, lam, options=CPU.replace(output="sparse"))
    needed = np.ones(S.shape[0], dtype=bool)
    W = blockwise_inverse(r.labels, r.Theta, needed)
    Wd = blockwise_inverse(r.labels, r.Theta.toarray(), needed)
    assert isinstance(W, SparseTheta)
    np.testing.assert_array_equal(W.toarray(), Wd)
    part = np.zeros_like(needed)
    part[:5] = True
    Wp = blockwise_inverse(r.labels, r.Theta, part).toarray()
    np.testing.assert_array_equal(Wp, blockwise_inverse(r.labels, r.Theta.toarray(), part))


@pytest.mark.parametrize("case", ["paper", "structured"])
def test_sparse_theta_matches_reference(case):
    """The same problem through both packages: the port's SparseTheta and
    the reference's hold the same components in the same layout, the same
    COO entry set, nnz, support and log-determinant."""
    if case == "paper":
        S = paper_synthetic(4, 10, seed=9)
        lam = 0.5 * sum(lambda_interval_for_k(S, 4))
    else:
        S, lam = structured_synthetic(10, 12, seed=6), 0.45
    ref = jax_glasso(S, lam, options=JaxOptions(output="sparse", solver_opts={"tol": 1e-9}))
    got = repro_torch.glasso(S, lam, options=CPU.replace(output="sparse"))
    T, R = got.Theta, ref.Theta
    assert isinstance(R, JaxSparseTheta)
    assert T.p == R.p and T.n_components == R.n_components and T.nnz == R.nnz
    np.testing.assert_array_equal(T._comp_id, R._comp_id)
    np.testing.assert_array_equal(T._pos_in, R._pos_in)
    np.testing.assert_array_equal(T.isolated, R.isolated)
    rt, ct, vt = T.to_coo()
    rr, cr, vr = R.to_coo()
    np.testing.assert_array_equal(rt, rr)
    np.testing.assert_array_equal(ct, cr)
    np.testing.assert_allclose(vt, vr, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(T.support_edges(), R.support_edges())
    assert T.logdet() == pytest.approx(R.logdet(), rel=1e-10)
    assert got.bytes_peak == ref.bytes_peak


def _pipeline_data():
    n, p, p_max = 40, 300, 16
    X = microarray_like(n, p, seed=7)
    return X, p_max


def test_large_scale_pipeline_matches_reference():
    """examples/large_scale_glasso.py's pipeline, small: microarray_like ->
    covgram (float32) -> correlation R in float64 -> capacity lambda for
    p_max -> device screen ("pallas", held to "host") -> bcd (tol 1e-7) at
    p_max with the screened labels and output="sparse"."""
    X, p_max = _pipeline_data()

    def corr(S):
        d = np.sqrt(np.clip(np.diag(S), 1e-12, None))
        R = (S / np.outer(d, d)).astype(np.float64)
        np.fill_diagonal(R, 1.0)
        return R

    S_port = covgram(torch.as_tensor(X, dtype=torch.float32)).numpy()
    S_ref = np.asarray(jax_covgram(jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(S_port, S_ref, rtol=0, atol=1e-5 * float(np.abs(S_ref).max()))
    R = corr(S_port)
    lam = lambda_for_max_component(R, p_max) * 1.0005
    assert lam == jax_capacity_lambda(R, p_max) * 1.0005
    eng = Engine(options=EngineOptions(device="cpu", cc_backend="pallas", output="sparse",
                                       solver="bcd", solver_opts={"tol": 1e-7}))
    labels, _ = eng.screen(R, lam)
    host = label_components(R, lam, backend="host")
    assert partitions_equal(labels, host)
    got = eng.run(R, lam, p_max=p_max, labels=labels)
    ref = JaxEngine(options=JaxOptions(solver="bcd", output="sparse", solver_opts={"tol": 1e-7})
                    ).run(R, lam, p_max=p_max, labels=host)
    assert isinstance(got.Theta, SparseTheta) and isinstance(ref.Theta, JaxSparseTheta)
    assert np.array_equal(got.labels, np.asarray(ref.labels))
    assert got.route_mix == ref.route_mix and max(got.block_sizes) <= p_max
    assert len(set(got.route_mix) - {"singleton"}) >= 2
    np.testing.assert_allclose(got.Theta.toarray(), ref.Theta.toarray(), rtol=0, atol=ATOL)
    assert kkt_residual_sparse(R, got.Theta, lam) < 1e-4


@pytest.mark.parametrize("case", ["correlation", "structured_ties"])
@pytest.mark.parametrize("p_max", [1, 4, 16, 64, 299])
def test_capacity_lambda_matches_reference(case, p_max, monkeypatch):
    """lambda_for_max_component walks the strongest edges first and falls
    back to the whole triangle; either way its lambda is the reference's
    full-profile lambda, exactly.  The structured case has exact zeros and
    tied values, where no positive floor may reach p_max."""
    from repro_torch.core import partition

    if case == "correlation":
        X = microarray_like(40, 300, seed=3)
        S = np.corrcoef(X.T)
    else:
        S = structured_synthetic(25, 12, seed=2)[:300, :300]
        S = np.round(S * 8) / 8  # dyadic values: many exact ties
    want = jax_capacity_lambda(S, p_max)
    assert lambda_for_max_component(S, p_max) == want
    if case == "correlation" and p_max <= 16:
        # the strongest 16 p edges already exceed p_max: no full sort
        def full_sort(*args, **kwargs):
            raise AssertionError("the whole triangle was sorted")

        monkeypatch.setattr(partition, "_sorted_edges", full_sort)
        assert lambda_for_max_component(S, p_max) == want
