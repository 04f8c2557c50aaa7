"""The port's joint K-class graphical lasso against the reference package.

``repro_torch.joint.joint_glasso`` (on the CPU: the plain versions of the
kernels) must reproduce ``repro.joint.joint_glasso`` on the same numpy
data: equal canonical union labels, route mix, fallbacks and ``router.*``
counters, Theta within ATOL = 1e-7 at tol 1e-9 (both sides stop their
ADMM on the same rule; eigh and the K-class sums round differently, so
iterates agree to rounding and the stopping iteration to +-1), and both
results within the joint KKT bound 1e-6 * max(1, max|S|).  The joint ADMM
is held lane by lane against the reference under ``jax.vmap``, with lanes
that finish at very different iteration counts.  Exact ties pick lam1 as
an existing |S_ij| of integer data with a power-of-two row count, so every
covariance entry is exact in any summation order."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import lambda_between_edges
from repro.core.instrument import reset as jax_reset
from repro.core.instrument import tail_counts as jax_tail_counts
from repro.covariance import structured_synthetic as jax_structured
from repro.engine import EngineOptions as JaxOptions
from repro.engine.registry import route_for as jax_route_for
from repro.joint import joint_admm_info as jax_joint_admm_info
from repro.joint import joint_glasso as jax_joint_glasso
from repro.joint import joint_kkt_residual as jax_joint_kkt
from repro.joint import joint_stream_screen as jax_joint_stream_screen
from repro.joint.screen import pair_excess as jax_pair_excess
from repro.kernels.covgram_screen import covgram_screen_tiles_stacked as jax_stacked
from repro.kernels.covgram_screen import pad_for_screen as jax_pad_for_screen
from repro.stream.unionfind import StreamingUnionFind as JaxUnionFind
from repro_torch import EngineOptions, glasso
from repro_torch.core import instrument
from repro_torch.core.components import component_lists, partitions_equal
from repro_torch.core.sparse import JointSparseTheta
from repro_torch.covariance import structured_synthetic
from repro_torch.engine.registry import route_for
from repro_torch.joint import (
    joint_admm_info,
    joint_glasso,
    joint_kkt_residual,
    joint_stream_screen,
    joint_thresholded_components,
    joint_union_adjacency,
)
from repro_torch.joint.blocks import assemble_joint_sparse
from repro_torch.joint.kkt import joint_kkt_residual_sparse
from repro_torch.joint.screen import pair_excess
from repro_torch.kernels.covgram_screen import covgram_screen_tiles_stacked, pad_for_screen
from repro_torch.stream.unionfind import StreamingUnionFind

ATOL = 1e-7
KKT_RTOL = 1e-6
PENALTIES = ("group", "fused")
CFG = {"tile": 32, "chunk": 16, "pair_batch": 3}


def _cpu(**kw):
    solver_opts = kw.pop("solver_opts", {"tol": 1e-9})
    return EngineOptions(device="cpu", output="dense", solver_opts=solver_opts, **kw)


def _jax(**kw):
    solver_opts = kw.pop("solver_opts", {"tol": 1e-9})
    return JaxOptions(output="dense", solver_opts=solver_opts, **kw)


def _class_covs(rng, K, p, n=32):
    """K moderately-correlated class covariances over shared variables."""
    base = rng.standard_normal((n, p)) * (0.3 + rng.random(p))
    out = []
    for _ in range(K):
        X = base + 0.7 * rng.standard_normal((n, p))
        Xc = X - X.mean(axis=0)
        out.append(Xc.T @ Xc / n)
    return out


def _dense_S(X):
    Xc = X - X.mean(axis=0)
    return Xc.T @ Xc / X.shape[0]


def _lam_pair(Ss, q):
    """(lam1, lam2) at a quantile midpoint of the class-max |S_ij|."""
    M = np.max(np.abs(np.stack(Ss)), axis=0)
    lam1 = lambda_between_edges(M, q)
    return lam1, 0.4 * lam1


def _kkt_bound(Ss):
    return KKT_RTOL * max(1.0, float(np.abs(np.stack(Ss)).max()))


def _both(Ss, lam1, lam2, penalty, *, port=None, ref=None, **kw):
    """The same joint solve through both packages, counters zeroed first;
    returns (reference result, port result, reference router counters, port
    router counters)."""
    jax_reset("router.")
    instrument.reset("router.")
    want = jax_joint_glasso(list(Ss), lam1, lam2, penalty=penalty, options=ref or _jax(), **kw)
    got = joint_glasso(list(Ss), lam1, lam2, penalty=penalty, options=port or _cpu(), **kw)
    return want, got, jax_tail_counts("router."), instrument.tail_counts("router.")


def _assert_parity(want, got, jc, tc, Ss):
    assert np.array_equal(got.labels, want.labels)
    assert got.route_mix == want.route_mix
    assert got.fallbacks == want.fallbacks
    assert tc == jc
    assert got.Theta.shape == want.Theta.shape
    assert np.abs(got.Theta - want.Theta).max() <= ATOL
    for res in (want, got):
        assert jax_joint_kkt(Ss, res.Theta, res.lam1, res.lam2, penalty=res.penalty) \
            <= _kkt_bound(Ss)


# ---------------------------------------------------------------------------
# joint_glasso(Ss) against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("shared", [0.5, 1.0])
def test_structured_joint_matches_reference(penalty, shared):
    """The routing ladder's rungs (singletons, joint_forest, joint_chordal,
    joint_shared, joint_general) on the bench generator at p = 64."""
    Ss = list(structured_synthetic(8, 8, classes=3, shared_fraction=shared, seed=4))
    want, got, jc, tc = _both(Ss, 0.4, 0.1, penalty)
    _assert_parity(want, got, jc, tc, Ss)
    assert len(got.route_mix) >= 2


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_random_joint_matches_reference(penalty, seed):
    """Class-specific covariances: every block takes the joint ADMM."""
    rng = np.random.default_rng(seed)
    Ss = _class_covs(rng, 2 + seed, 16)
    lam1, lam2 = _lam_pair(Ss, 0.7)
    want, got, jc, tc = _both(Ss, lam1, lam2, penalty)
    _assert_parity(want, got, jc, tc, Ss)


@pytest.mark.parametrize("penalty", PENALTIES)
def test_unscreened_baseline_matches_reference(penalty):
    """screen=False and route=False: one global joint_general block."""
    rng = np.random.default_rng(7)
    Ss = _class_covs(rng, 3, 12)
    lam1, lam2 = _lam_pair(Ss, 0.6)
    want, got, jc, tc = _both(
        Ss, lam1, lam2, penalty, port=_cpu(route=False), ref=_jax(route=False), screen=False
    )
    _assert_parity(want, got, jc, tc, Ss)
    assert got.route_mix == {"joint_general": 1}
    screened = joint_glasso(Ss, lam1, lam2, penalty=penalty, options=_cpu())
    assert np.abs(screened.Theta - got.Theta).max() < 1e-6


# ---------------------------------------------------------------------------
# the joint ADMM, lane by lane, against the reference under vmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", PENALTIES)
def test_admm_lanes_match_reference_vmap(penalty):
    """Lanes with their own lam1/lam2 that stop at very different
    iteration counts: each lane's count within +-1 of the reference's and
    Theta within ATOL; a finished lane is frozen, so each lane equals its
    own solve as a bucket of one."""
    rng = np.random.default_rng(3)
    K, b = 3, 10
    stack = np.stack([np.stack(_class_covs(rng, K, b, n=24)) for _ in range(4)])
    stack[3] = np.eye(b) + 1e-3 * stack[3]  # nearly diagonal: stops early
    lam1 = np.array([0.15, 0.05, 0.3, 0.01])
    lam2 = np.array([0.1, 0.02, 0.0, 0.05])
    opts = dict(penalty=penalty, tol=1e-9, max_iter=2000)
    theta, iters = joint_admm_info(
        torch.as_tensor(stack), torch.as_tensor(lam1), torch.as_tensor(lam2), **opts
    )
    jt, jit = jax.vmap(lambda S, l1, l2: jax_joint_admm_info(S, l1, l2, **opts))(
        jnp.asarray(stack), jnp.asarray(lam1), jnp.asarray(lam2)
    )
    iters, jit = iters.numpy(), np.asarray(jit)
    assert np.abs(iters.astype(np.int64) - jit).max() <= 1
    assert iters.max() > 2 * iters.min()  # the lanes really finish apart
    assert np.abs(theta.numpy() - np.asarray(jt)).max() <= ATOL
    for lane in range(4):
        one, n_one = joint_admm_info(
            torch.as_tensor(stack[lane : lane + 1]), lam1[lane], lam2[lane], **opts
        )
        assert int(n_one[0]) == int(iters[lane])
        assert np.abs(one[0].numpy() - theta[lane].numpy()).max() <= 1e-12


def test_admm_warm_start_matches_reference():
    """A W0/Theta0 warm pair per lane, one of them not finite (cold)."""
    rng = np.random.default_rng(11)
    K, b = 2, 8
    stack = np.stack([np.stack(_class_covs(rng, K, b, n=24)) for _ in range(2)])
    opts = dict(penalty="group", tol=1e-9)
    cand, _ = joint_admm_info(torch.as_tensor(stack), 0.12, 0.05, **opts)
    T0 = cand.numpy().copy()
    W0 = np.linalg.inv(T0)
    W0[1, 0, 0, 0] = np.nan
    theta, iters = joint_admm_info(
        torch.as_tensor(stack), 0.1, 0.05, W0=torch.as_tensor(W0),
        Theta0=torch.as_tensor(T0), **opts,
    )
    jt, jit = jax.vmap(
        lambda S, w, t: jax_joint_admm_info(S, 0.1, 0.05, W0=w, Theta0=t, **opts)
    )(jnp.asarray(stack), jnp.asarray(W0), jnp.asarray(T0))
    assert np.abs(iters.numpy().astype(np.int64) - np.asarray(jit)).max() <= 1
    assert np.abs(theta.numpy() - np.asarray(jt)).max() <= ATOL


# ---------------------------------------------------------------------------
# the screen: ties, backends, lam2 = 0, strictness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", PENALTIES)
def test_exact_per_class_ties_are_not_edges(penalty):
    """lam1 is an attained |S^(1)_ij| (an element of the values, not a
    median): the tie is not an edge, and the port's screen equals the
    pairwise oracle, the reference's screen, every cc backend and the
    streamed screen."""
    rng = np.random.default_rng(21)
    K, n, p = 3, 16, 30
    Xs = [rng.integers(-4, 5, size=(n, p)).astype(np.float64) for _ in range(K)]
    Ss = [_dense_S(X) for X in Xs]
    vals = np.abs(Ss[0][np.triu_indices(p, 1)])
    vals = np.sort(vals[vals > 0])
    lam1 = float(vals[vals.size // 2])
    lam2 = 0.25
    assert (np.abs(Ss[0][np.triu_indices(p, 1)]) == lam1).any()
    labels, stats = joint_thresholded_components(Ss, lam1, lam2, penalty=penalty)
    iu, ju = np.triu_indices(p, 1)
    svec = np.stack([S[iu, ju] for S in Ss])
    edge = jax_pair_excess(svec, lam1, lam2, penalty=penalty) > 0.0
    uf = JaxUnionFind(p)
    uf.union_edges(iu[edge], ju[edge])
    assert np.array_equal(labels, uf.labels())
    assert stats.n_edges == int(edge.sum())
    for backend in ("host", "jax", "pallas"):
        lab_b, _ = joint_thresholded_components(
            Ss, lam1, lam2, penalty=penalty, backend=backend, device="cpu"
        )
        assert np.array_equal(labels, lab_b), backend
    sc = joint_stream_screen(Xs, lam1, lam2, penalty=penalty, config=CFG, device="cpu")
    assert np.array_equal(labels, sc.labels)
    assert sc.stats.n_edges == stats.n_edges
    want, got, jc, tc = _both(Ss, lam1, lam2, penalty)
    _assert_parity(want, got, jc, tc, Ss)


def test_lam2_zero_screen_is_the_union_of_per_class_screens():
    rng = np.random.default_rng(2)
    Ss = _class_covs(rng, 3, 24)
    lam1, _ = _lam_pair(Ss, 0.7)
    labels, _ = joint_thresholded_components(Ss, lam1, 0.0, penalty="group")
    adj = np.zeros((24, 24), dtype=bool)
    for S in Ss:
        A = np.abs(S) > lam1
        np.fill_diagonal(A, False)
        adj |= A
    iu, ju = np.nonzero(np.triu(adj, 1))
    uf = StreamingUnionFind(24)
    uf.union_edges(iu, ju)
    assert partitions_equal(labels, uf.labels())
    lab_f, _ = joint_thresholded_components(Ss, lam1, 0.0, penalty="fused")
    assert partitions_equal(labels, lab_f)


@pytest.mark.parametrize("penalty", PENALTIES)
def test_pair_excess_and_union_adjacency_match_reference(penalty):
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((4, 50))
    np.testing.assert_array_equal(
        pair_excess(vals, 0.3, 0.2, penalty=penalty),
        jax_pair_excess(vals, 0.3, 0.2, penalty=penalty),
    )
    from repro.joint import joint_union_adjacency as jax_adjacency

    Ss = _class_covs(rng, 3, 14)
    assert np.array_equal(
        joint_union_adjacency(Ss, 0.2, 0.1, penalty=penalty),
        jax_adjacency(Ss, 0.2, 0.1, penalty=penalty),
    )


def test_union_adjacency_strictness():
    """The hybrid conditions are strict: exact equality is not an edge."""
    S1 = np.eye(2)
    S1[0, 1] = S1[1, 0] = 0.5
    assert not joint_union_adjacency([S1, S1], 0.5, 0.0, penalty="group").any()
    assert joint_union_adjacency([S1, S1], 0.499, 0.0, penalty="group").any()
    assert not joint_union_adjacency([S1, S1], 0.5, 0.0, penalty="fused").any()
    lam2_tie = float(np.sqrt(2) * 0.2)
    assert not joint_union_adjacency([S1, S1], 0.3, lam2_tie + 1e-12, penalty="group").any()
    assert joint_union_adjacency([S1, S1], 0.3, lam2_tie - 1e-9, penalty="group").any()


# ---------------------------------------------------------------------------
# lam2 = 0, the fast path, fallbacks, verify_tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", PENALTIES)
def test_lam2_zero_matches_independent_port_glasso(penalty):
    rng = np.random.default_rng(9)
    K, p = 3, 18
    Ss = _class_covs(rng, K, p)
    lam1, _ = _lam_pair(Ss, 0.6)
    res = joint_glasso(Ss, lam1, 0.0, penalty=penalty, options=_cpu())
    for k in range(K):
        direct = glasso(Ss[k], lam1, options=_cpu())
        assert np.abs(res.Theta[k] - direct.Theta).max() < 1e-6


def _shared_tree_problem(p=16, K=3):
    """Identical class blocks: a planted tree + a pair + singletons."""
    Ss = [np.eye(p) * 2.0 for _ in range(K)]
    for k in range(K):
        for i, j, v in [(0, 1, 0.9), (1, 2, -0.8), (2, 3, 0.7), (3, 4, 0.75), (6, 7, 0.85)]:
            Ss[k][i, j] = Ss[k][j, i] = v
    return Ss


@pytest.mark.parametrize("penalty", PENALTIES)
def test_joint_forest_fast_path_exact(penalty):
    Ss = _shared_tree_problem()
    instrument.reset("joint.")
    want, got, jc, tc = _both(Ss, 0.4, 0.12, penalty)
    _assert_parity(want, got, jc, tc, Ss)
    assert got.route_mix.get("joint_forest", 0) >= 2
    assert got.fallbacks == 0
    assert instrument.count("joint.closed_form_blocks") >= 2
    unrouted = joint_glasso(Ss, 0.4, 0.12, penalty=penalty,
                            options=_cpu(route=False, solver_opts={"tol": 1e-10}))
    assert unrouted.route_mix != got.route_mix
    assert np.abs(got.Theta - unrouted.Theta).max() < 1e-6
    assert np.abs(got.Theta[0] - got.Theta[-1]).max() == 0.0


def test_near_identical_blocks_fall_back_not_corrupt():
    """Blocks equal to 1e-6, past the classifier's 1e-12 identity gate: the
    perturbed component takes the joint ADMM, as in the reference."""
    Ss = _shared_tree_problem()
    Ss[1] = Ss[1].copy()
    Ss[1][0, 1] = Ss[1][1, 0] = 0.9 + 1e-6
    want, got, jc, tc = _both(Ss, 0.4, 0.12, "group")
    _assert_parity(want, got, jc, tc, Ss)
    assert got.route_mix.get("joint_general", 0) >= 1
    ref = joint_glasso(Ss, 0.4, 0.12, penalty="group",
                       options=_cpu(route=False, solver_opts={"tol": 1e-10}))
    assert np.abs(got.Theta - ref.Theta).max() < 1e-6


def test_forced_fast_path_falls_back_and_repairs(monkeypatch):
    """Near-identical blocks forced onto the forest rung by a classifier
    that calls them shared: the per-class KKT check rejects the candidate
    and the warm joint-ADMM re-dispatch repairs it (joint.fallbacks)."""
    import repro_torch.joint.blocks as blocks_mod

    Ss = _shared_tree_problem()
    Ss[1] = Ss[1].copy()
    Ss[1][0, 1] = Ss[1][1, 0] = 0.9 + 5e-3
    real = blocks_mod.classify_joint_component

    def forced(Ss_, comp, lam1, lam2, *, penalty):
        cls = real(Ss_, comp, lam1, lam2, penalty=penalty)
        return "joint_forest" if cls == "joint_general" else cls

    monkeypatch.setattr(blocks_mod, "classify_joint_component", forced)
    instrument.reset("joint.")
    instrument.reset("router.")
    res = joint_glasso(Ss, 0.4, 0.12, penalty="group", options=_cpu())
    assert res.fallbacks >= 1
    assert instrument.count("joint.fallbacks") == res.fallbacks
    assert instrument.count("router.fallback.joint_forest") == res.fallbacks
    monkeypatch.setattr(blocks_mod, "classify_joint_component", real)
    ref = joint_glasso(Ss, 0.4, 0.12, penalty="group",
                       options=_cpu(route=False, solver_opts={"tol": 1e-10}))
    assert np.abs(res.Theta - ref.Theta).max() < 1e-6


def test_verify_tail_passes_and_repairs():
    rng = np.random.default_rng(0)
    K, p = 3, 14
    Ss = _class_covs(rng, K, p)
    lam1, lam2 = _lam_pair(Ss, 0.55)
    res = joint_glasso(Ss, lam1, lam2, penalty="group", options=_cpu(verify_tail=True))
    assert res.fallbacks == 0
    ref = joint_glasso(Ss, lam1, lam2, penalty="group", screen=False,
                       options=_cpu(route=False, solver_opts={"tol": 1e-10}))
    assert np.abs(res.Theta - ref.Theta).max() < 1e-6
    assert res.route_mix.get("joint_general", 0)
    instrument.reset("joint.")
    starved_opts = dict(verify_tail=True, solver_opts={"tol": 1e-9, "max_iter": 3})
    starved = joint_glasso(Ss, lam1, lam2, penalty="group", options=_cpu(**starved_opts))
    assert starved.fallbacks > 0
    assert instrument.count("joint.fallbacks") == starved.fallbacks
    assert np.abs(starved.Theta - ref.Theta).max() < 1e-5
    want = jax_joint_glasso(Ss, lam1, lam2, penalty="group", options=_jax(**starved_opts))
    assert want.fallbacks == starved.fallbacks


@pytest.mark.parametrize("penalty", PENALTIES)
def test_joint_kkt_verifier_matches_reference(penalty):
    rng = np.random.default_rng(6)
    K, b = 3, 10
    Ss = np.stack(_class_covs(rng, K, b, n=24))
    for lam2 in (0.0, 0.1):
        Th, _ = joint_admm_info(torch.as_tensor(Ss[None]), 0.15, lam2, penalty=penalty,
                                tol=1e-10)
        Th = Th[0].numpy()
        res = joint_kkt_residual(Ss, Th, 0.15, lam2, penalty=penalty)
        assert res < 1e-7
        assert res == jax_joint_kkt(Ss, Th, 0.15, lam2, penalty=penalty)
        bad = Th.copy()
        bad[0, 0, 1] += 0.03
        bad[0, 1, 0] += 0.03
        assert joint_kkt_residual(Ss, bad, 0.15, lam2, penalty=penalty) > 1e-3


# ---------------------------------------------------------------------------
# from data: the streamed screen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", PENALTIES)
def test_streamed_joint_matches_dense_and_reference(penalty):
    rng = np.random.default_rng(31 + len(penalty))
    K, n, p = 3, 40, 45  # p not a multiple of tile=32
    Xs = [rng.standard_normal((n, p)) * (0.1 + rng.random(p)) for _ in range(K)]
    Ss = [_dense_S(X) for X in Xs]
    lam1, lam2 = _lam_pair(Ss, 0.7)
    dense = joint_glasso(Ss, lam1, lam2, penalty=penalty, options=_cpu())
    jax_reset("router.")
    instrument.reset("router.")
    want = jax_joint_glasso(Xs=Xs, lam1=lam1, lam2=lam2, penalty=penalty, from_data=True,
                            stream=CFG, options=_jax())
    got = joint_glasso(Xs=Xs, lam1=lam1, lam2=lam2, penalty=penalty, from_data=True,
                       stream=CFG, options=_cpu())
    _assert_parity(want, got, jax_tail_counts("router."), instrument.tail_counts("router."), Ss)
    assert np.array_equal(got.labels, dense.labels)
    assert got.route_mix == dense.route_mix
    assert np.abs(got.Theta - dense.Theta).max() < 1e-6
    for field in ("candidate_pairs", "tiles_total", "tiles_skipped", "n_edges"):
        assert getattr(got.screen, field) == getattr(want.screen, field), field
    assert got.screen.candidate_pairs >= got.screen.n_edges


def test_streamed_candidates_match_reference_bit_for_bit():
    """Integer data: the candidate K-vectors (emitted and completed) equal
    the reference's exactly."""
    rng = np.random.default_rng(8)
    Xs = [rng.integers(-4, 5, size=(16, 40)).astype(np.float64) for _ in range(3)]
    want = jax_joint_stream_screen(Xs, 1.0, 0.5, penalty="fused", config=CFG)
    got = joint_stream_screen(Xs, 1.0, 0.5, penalty="fused", config=CFG, device="cpu")
    for a, b in zip(got.candidates, want.candidates):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert np.array_equal(got.labels, want.labels)


def test_stacked_covgram_screen_matches_reference():
    rng = np.random.default_rng(12)
    p, tile, chunk = 40, 16, 8
    xs = [rng.integers(-3, 4, size=(n, p)).astype(np.float64) for n in (8, 16)]
    sched = [(np.array([0, 0, 1]), np.array([0, 2, 1])), (np.array([1, 2]), np.array([2, 2]))]
    got_pads = [pad_for_screen(torch.as_tensor(x), x.mean(0), block_n=chunk, block_p=tile)
                for x in xs]
    want_pads = [jax_pad_for_screen(x, x.mean(0), block_n=chunk, block_p=tile) for x in xs]
    kw = dict(n_trues=[8, 16], p_true=p, block_p=tile, pair_batch=2)
    got = covgram_screen_tiles_stacked([g[0] for g in got_pads], [g[1] for g in got_pads],
                                       [s[0] for s in sched], [s[1] for s in sched], 1.0, **kw)
    want = jax_stacked([w[0] for w in want_pads], [w[1] for w in want_pads],
                       [s[0] for s in sched], [s[1] for s in sched], 1.0, block_n=chunk,
                       backend="ref", **kw)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert sum(g[0].size for g in got) > 0


# ---------------------------------------------------------------------------
# surface: validation, not-ported options, result, registry, generator
# ---------------------------------------------------------------------------


def test_joint_glasso_input_validation():
    opts = _cpu()
    with pytest.raises(ValueError, match="needs"):
        joint_glasso(lam1=0.5, options=opts)
    with pytest.raises(ValueError, match="not both"):
        joint_glasso([np.eye(3)], 0.5, Xs=[np.zeros((4, 3))], options=opts)
    with pytest.raises(ValueError, match="unknown joint penalty"):
        joint_glasso([np.eye(3)], 0.5, penalty="nope", options=opts)
    with pytest.raises(ValueError, match="share one shape"):
        joint_glasso([np.eye(3), np.eye(4)], 0.5, options=opts)
    with pytest.raises(ValueError, match="not a joint solver"):
        joint_glasso([np.eye(3)], 0.5, options=_cpu(solver="bcd"))
    with pytest.raises(ValueError, match="needs the data"):
        joint_glasso(lam1=0.5, from_data=True, options=opts)
    with pytest.warns(DeprecationWarning):
        joint_glasso([np.eye(3)], 0.5, device="cpu", output="dense")


def test_sparse_joint_output_is_not_ported():
    """Sparse joint results are ported now: the all-isolated case assembles
    a JointSparseTheta with no blocks, equal to the dense stack, and its
    sparse KKT residual is the closed form's."""
    res = joint_glasso([np.eye(3)] * 2, 0.5, options=EngineOptions(device="cpu", output="sparse"))
    assert isinstance(res.Theta, JointSparseTheta) and res.output == "sparse"
    np.testing.assert_array_equal(res.Theta.toarray(), np.stack([np.eye(3) / 1.5] * 2))
    assert joint_kkt_residual_sparse([np.eye(3)] * 2, res.Theta, 0.5, 0.0) == 0.0
    empty = assemble_joint_sparse(_all_isolated_plan(), [], [np.eye(3)] * 2)
    assert empty.n_components == 3 and empty.nnz == 6


def _all_isolated_plan():
    from repro_torch.joint.blocks import JointPlan

    return JointPlan(p=3, K=2, lam1=0.5, lam2=0.0, penalty="group",
                     labels=np.arange(3), isolated=np.arange(3), buckets=[])


def test_joint_glasso_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        joint_glasso([np.eye(3)] * 2, 0.5)


def test_result_surface():
    Ss = _shared_tree_problem()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = joint_glasso(Ss, 0.4, 0.1, penalty="group", options=_cpu())
    assert res.K == 3 and res.Theta.shape == (3, 16, 16)
    assert res.support.shape == (16, 16) and res.class_support(0).dtype == bool
    assert res.screen is not None and res.screen.n_components >= 2
    assert res.block_sizes == sorted(
        (len(c) for c in component_lists(res.labels) if len(c) > 1), reverse=True
    )
    edges = res.support_edges()
    assert edges.shape[1] == 2 and (edges[:, 0] < edges[:, 1]).all()
    assert set(res.stages()) == {"screen", "solve", "dispatch", "assemble"}
    assert res.trace is not None
    names = {sp.name for sp in res.trace.spans}
    assert {"engine.joint", "engine.screen", "engine.plan", "engine.solve",
            "engine.barrier", "engine.assemble"} <= names


@pytest.mark.parametrize(
    "structure", ["joint_forest", "joint_chordal", "joint_shared", "joint_general"]
)
def test_joint_routes_match_reference(structure):
    assert route_for(structure) == jax_route_for(structure)


def test_multiclass_generator_is_the_reference_bit_for_bit():
    for kw in (dict(classes=3, shared_fraction=0.6), dict(classes=2), dict(classes=1)):
        np.testing.assert_array_equal(
            structured_synthetic(9, 6, seed=5, **kw), jax_structured(9, 6, seed=5, **kw)
        )


def test_unionfind_matches_reference():
    rng = np.random.default_rng(1)
    gi, gj = rng.integers(0, 50, size=(2, 40))
    a, b = StreamingUnionFind(50), JaxUnionFind(50)
    assert a.union_edges(gi, gj) == b.union_edges(gi, gj)
    assert np.array_equal(a.labels(), b.labels())


def test_options_from_reference_drive_the_joint_engine():
    """One configuration value drives both packages."""
    ref = _jax(route=False)
    opts = EngineOptions.from_reference(dataclasses.asdict(ref), device="cpu")
    Ss = _shared_tree_problem(p=8, K=2)
    res = joint_glasso(Ss, 0.4, 0.1, options=opts)
    assert set(res.route_mix) <= {"joint_general", "singleton"}
