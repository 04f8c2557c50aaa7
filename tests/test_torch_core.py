"""``repro_torch.core``'s public surface against the reference's
``repro.core``: the same 25 names, each held to its reference counterpart
on the same small numpy inputs.  Partitions, profiles and plans are exact;
the single-block solvers agree within the tolerances their stack forms are
held to elsewhere (bcd 1e-9 in ``test_torch_bucket_glasso.py``, pg 1e-6 and
admm 1e-9 in ``test_torch_solvers.py``), the objective and KKT residual to
1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch
import repro_torch.core as core
from conftest import lambda_between_edges, random_covariance
from repro.core.blocks import build_plan as jax_build_plan, solve_bucket as jax_solve_bucket
from repro.core.instrument import count as jax_count, reset as jax_reset
from repro.core.solvers import CLOSED_FORM_SOLVERS as JAX_CLOSED_FORM
from repro.core.solvers import glasso_forest as jax_glasso_forest
from repro.core.solvers import warm_start_solvers as jax_warm_start_solvers
from repro.core.solvers.kkt import glasso_objective as jax_objective
from repro_torch.core.blocks import build_plan, solve_bucket
from repro_torch.core.instrument import count, reset
from repro_torch.core.solvers import (
    CLOSED_FORM_SOLVERS,
    WARM_START_SOLVERS,
    glasso_forest,
    warm_start_solvers,
)
from repro_torch.core.solvers.kkt import glasso_objective
from repro_torch.engine.structure import classify_component

SOLVER_ATOL = {"glasso_bcd": 1e-9, "glasso_pg": 1e-6, "glasso_admm": 1e-9}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The solvers' CPU loops run many tiny batched operations; torch's
    worker threads only spin on them and starve the parallel test
    workers.  Each test runs on one thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=0, p=14, q=0.7):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    return S, lambda_between_edges(S, q)


def test_core_exports_the_reference_surface():
    assert sorted(core.__all__) == sorted(ref_core.__all__)
    assert len(core.__all__) == 25
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    assert core.glasso is repro_torch.glasso and core.glasso_path is repro_torch.glasso_path
    assert core.EngineOptions is repro_torch.EngineOptions
    assert core.GlassoResult is repro_torch.GlassoResult
    assert sorted(core.SOLVERS) == sorted(ref_core.SOLVERS)
    assert core.AUTO_SPARSE_P == ref_core.AUTO_SPARSE_P
    assert sorted(CLOSED_FORM_SOLVERS) == sorted(JAX_CLOSED_FORM)
    assert warm_start_solvers() == jax_warm_start_solvers()
    assert set(WARM_START_SOLVERS) == {"admm", "bcd", "fused_bcd"}


@pytest.mark.parametrize("seed,q", [(0, 0.5), (1, 0.8), (2, 0.95)])
def test_partitions_match_reference(seed, q):
    """Adjacency, the host union-find, label propagation, canonical labels,
    Theorem-1 equality, Theorem-2 refinement and the screen's stats."""
    S, lam = _case(seed, p=16, q=q)
    A = core.threshold_adjacency(S, lam)
    assert np.array_equal(A, ref_core.threshold_adjacency(S, lam))
    host = core.connected_components_host(A)
    assert np.array_equal(host, ref_core.connected_components_host(A))
    from_cov = core.components_from_covariance_host(S, lam)
    assert np.array_equal(from_cov, ref_core.components_from_covariance_host(S, lam))
    lp = core.connected_components_labelprop(torch.as_tensor(S), lam).numpy()
    lp_ref = np.asarray(ref_core.connected_components_labelprop(jnp.asarray(S), lam))
    assert np.array_equal(core.canonicalize_labels(lp), ref_core.canonicalize_labels(lp_ref))
    assert core.partitions_equal(lp, host) and ref_core.partitions_equal(lp_ref, host)
    shuffled = np.random.default_rng(seed).permutation(S.shape[0])[host]
    assert np.array_equal(core.canonicalize_labels(shuffled),
                          ref_core.canonicalize_labels(shuffled))
    labels, stats = core.thresholded_components(S, lam)
    labels_ref, stats_ref = ref_core.thresholded_components(S, lam)
    assert np.array_equal(labels, labels_ref)
    for field in ("n_components", "max_comp", "n_isolated", "n_edges"):
        assert getattr(stats, field) == getattr(stats_ref, field), field
    coarse = core.components_from_covariance_host(S, 0.8 * lam)
    for fine_, coarse_ in ((labels, coarse), (coarse, labels)):
        assert core.is_refinement(fine_, coarse_) == ref_core.is_refinement(fine_, coarse_)
    assert core.is_refinement(labels, coarse)


def test_partition_profiles_match_reference():
    """merge_profile, labels_at_thresholds, lambda_for_max_component and
    component_size_distribution (one union-find pass for the grid)."""
    S, _ = _case(3, p=18)
    prof, prof_ref = core.merge_profile(S), ref_core.merge_profile(S)
    assert sorted(prof) == sorted(prof_ref)
    for k in prof:
        assert np.array_equal(np.asarray(prof[k]), np.asarray(prof_ref[k])), k
    lams = np.sort(np.abs(S[np.triu_indices(18, 1)]))[::-3][:6]
    for a, b in zip(core.labels_at_thresholds(S, lams), ref_core.labels_at_thresholds(S, lams)):
        assert np.array_equal(a, b)
    for p_max in (1, 3, 8, 18):
        assert core.lambda_for_max_component(S, p_max) == ref_core.lambda_for_max_component(S, p_max)
    reset("partition.")
    jax_reset("partition.")
    dist = core.component_size_distribution(S, lams)
    dist_ref = ref_core.component_size_distribution(S, lams)
    assert count("partition.unionfind_passes") == jax_count("partition.unionfind_passes") == 1
    assert len(dist) == len(dist_ref) == len(lams)
    for d, r in zip(dist, dist_ref):
        assert sorted(d) == sorted(r)
        assert d["lambda"] == r["lambda"]
        assert d["n_components"] == r["n_components"] and d["max_comp"] == r["max_comp"]
        assert np.array_equal(d["sizes"], r["sizes"]) and np.array_equal(d["counts"], r["counts"])
        assert int((d["sizes"] * d["counts"]).sum()) == 18


@pytest.mark.parametrize("name", ["glasso_bcd", "glasso_pg", "glasso_admm"])
@pytest.mark.parametrize("warm", [False, True])
def test_single_block_solvers_match_reference(name, warm):
    """``solve(S, lam, **opts) -> Theta`` on one block, cold and warm
    (W0 and Theta0 from the solution at a 20% larger lambda), against the
    reference's single-block solver."""
    S, lam = _case(4, p=9, q=0.6)
    opts = {"tol": 1e-9}
    warm_kw = {}
    if warm:
        T = np.array(getattr(ref_core, name)(jnp.asarray(S), 1.2 * lam, **opts))
        warm_kw = {"W0": np.linalg.inv(T), "Theta0": T}
    got = getattr(core, name)(torch.as_tensor(S), lam, **opts, **{
        k: torch.as_tensor(v) for k, v in warm_kw.items()})
    want = np.asarray(getattr(ref_core, name)(jnp.asarray(S), lam, **opts, **{
        k: jnp.asarray(v) for k, v in warm_kw.items()}))
    assert isinstance(got, torch.Tensor) and got.shape == (9, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOLVER_ATOL[name])
    # numpy inputs go where ``device`` says, and a 0-d tensor lam is taken
    again = getattr(core, name)(S, torch.tensor(lam, dtype=torch.float64), **opts, **warm_kw,
                                device="cpu")
    assert again.device.type == "cpu" and torch.equal(again, got)
    _numpy_input_defaults_to_the_card(getattr(core, name), S, lam)


def _numpy_input_defaults_to_the_card(solve, S, lam):
    """An array S without ``device`` runs on "cuda", the port's default:
    it raises where there is no CUDA, and lands on the card where there
    is."""
    if torch.cuda.is_available():
        assert solve(S, lam).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solve(S, lam)


def test_kkt_residual_and_objective_match_reference():
    from repro.core.solvers.kkt import kkt_residual as jax_kkt

    S, lam = _case(5, p=10, q=0.6)
    T = np.array(ref_core.glasso_bcd(jnp.asarray(S), lam, tol=1e-9))
    for Theta in (T, T + 1e-3 * np.eye(10), np.eye(10)):
        got = float(core.kkt_residual(torch.as_tensor(S), torch.as_tensor(Theta), lam))
        want = float(jax_kkt(jnp.asarray(S), jnp.asarray(Theta), lam))
        assert got == pytest.approx(want, rel=1e-12, abs=1e-15)
        got = float(glasso_objective(torch.as_tensor(S), torch.as_tensor(Theta), lam))
        want = float(jax_objective(jnp.asarray(S), jnp.asarray(Theta), lam))
        assert got == pytest.approx(want, rel=1e-12)
    neg = np.diag([-1.0] + [1.0] * 9)  # not positive definite: inf, as the reference
    assert float(glasso_objective(torch.as_tensor(S), torch.as_tensor(neg), lam)) == np.inf
    assert float(jax_objective(jnp.asarray(S), jnp.asarray(neg), lam)) == np.inf
    stack = glasso_objective(torch.as_tensor(np.stack([S, S])), torch.as_tensor(np.stack([T, neg])),
                             lam)
    assert stack.shape == (2,) and float(stack[1]) == np.inf


def test_closed_form_solvers_match_reference():
    """``CLOSED_FORM_SOLVERS["forest"]`` on a tree block and
    ``["chordal"]`` on a chordal one, against the reference's."""
    p = 6
    S = np.eye(p) * 2.0
    for i, j, v in ((0, 1, 0.8), (1, 2, -0.6), (1, 3, 0.5), (3, 4, 0.45), (4, 5, -0.4)):
        S[i, j] = S[j, i] = v
    lam = 0.3
    got = glasso_forest(torch.as_tensor(S), lam).numpy()
    want = np.asarray(jax_glasso_forest(jnp.asarray(S), lam))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert np.array_equal(glasso_forest(S, lam, device="cpu").numpy(), got)
    _numpy_input_defaults_to_the_card(glasso_forest, S, lam)
    assert CLOSED_FORM_SOLVERS["forest"] is glasso_forest
    C = np.eye(4) * 2.0
    for i, j in ((0, 1), (1, 2), (2, 3), (3, 0), (0, 2)):
        C[i, j] = C[j, i] = 0.45 * (1 if (i + j) % 2 else -1)
    np.testing.assert_allclose(CLOSED_FORM_SOLVERS["chordal"](C, lam),
                               JAX_CLOSED_FORM["chordal"](C, lam), rtol=0, atol=1e-13)


@pytest.mark.parametrize("classify", [False, True])
def test_build_plan_matches_reference(classify):
    """Buckets, their padded sizes, members, structure classes and stacks;
    the single-block bucket's mild padding above 256."""
    S, lam = _case(6, p=24, q=0.85)
    labels, _ = core.thresholded_components(S, lam)
    kw = {}
    if classify:
        from repro.engine.structure import classify_component as jax_classify

        kw_ref = {"classify": lambda c: jax_classify(S, c, lam)}
        kw = {"classify": lambda c: classify_component(S, c, lam)}
    else:
        kw_ref = {}
    plan = build_plan(S, lam, labels, **kw)
    ref = jax_build_plan(S, lam, labels, **kw_ref)
    assert plan.p == ref.p and plan.lam == ref.lam
    assert np.array_equal(plan.isolated, ref.isolated)
    assert len(plan.buckets) == len(ref.buckets) > 0
    for b, r in zip(plan.buckets, ref.buckets):
        assert (b.size, b.structure) == (r.size, r.structure)
        assert all(np.array_equal(x, y) for x, y in zip(b.comps, r.comps))
        assert np.array_equal(b.blocks, r.blocks)
    big = build_plan(np.eye(300) + 0.5, 0.1, np.zeros(300, dtype=np.int64))
    assert big.buckets[0].size == jax_build_plan(
        np.eye(300) + 0.5, 0.1, np.zeros(300, dtype=np.int64)).buckets[0].size == 384


def test_solve_bucket_matches_reference():
    """One bucket's stack at one lam through a registered name or a
    batched fn, cold and with a W0 stack, against the reference's vmapped
    single-block solver."""
    S, lam = _case(7, p=20, q=0.8)
    labels, _ = core.thresholded_components(S, lam)
    bucket = max(build_plan(S, lam, labels).buckets, key=lambda b: len(b.comps))
    blocks = bucket.blocks
    want = np.asarray(jax_solve_bucket(jnp.asarray(blocks), lam, ref_core.glasso_bcd, tol=1e-9))
    got = solve_bucket(blocks, lam, "bcd", tol=1e-9, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    assert torch.equal(solve_bucket(torch.as_tensor(blocks), lam, core.SOLVERS["bcd"], tol=1e-9), got)
    _numpy_input_defaults_to_the_card(
        lambda B, lam: solve_bucket(B, lam, "bcd", tol=1e-9), blocks, lam)
    W0 = blocks + 1.3 * lam * np.eye(bucket.size)[None]
    want = np.asarray(jax_solve_bucket(jnp.asarray(blocks), lam, ref_core.glasso_bcd,
                                       W0=jnp.asarray(W0), tol=1e-9))
    got = solve_bucket(blocks, lam, "bcd", W0=W0, tol=1e-9, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="unknown solver"):
        solve_bucket(blocks, lam, "nope", device="cpu")


def test_sparse_result_types_match_reference():
    """``result_nbytes`` of a dense and of a sparse result, and the
    sparse result types the surface exports."""
    S, lam = _case(8, p=12, q=0.8)
    opts = core.EngineOptions(device="cpu", output="sparse")
    got = core.glasso(S, lam, options=opts)
    want = ref_core.glasso(S, lam, options=ref_core.EngineOptions(output="sparse"))
    assert isinstance(got.Theta, core.SparseTheta)
    assert isinstance(want.Theta, ref_core.SparseTheta)
    assert core.result_nbytes(got.Theta) == ref_core.result_nbytes(want.Theta)
    dense = np.zeros((5, 5))
    assert core.result_nbytes(dense) == ref_core.result_nbytes(dense) == 200
    assert core.JointSparseTheta.__name__ == ref_core.JointSparseTheta.__name__
