"""The port's lambda path (``repro_torch.glasso_path``) against the reference
package's ``repro.core.glasso_path``.

Each case feeds the same numpy S (or X) and grid to both packages (the port
on the CPU: the kernels' plain PyTorch versions) and requires, step by
step: identical canonical labels and route mix, identical planner counters
(``planner.plans_built`` / ``buckets_padded`` / ``buckets_reused``, one
``partition.unionfind_passes``) and identical ``select.warm.*`` counts;
Theta within THETA_ATOL = 1e-7, and both results within the reference's
``kkt_residual`` bound 1e-5 max|S|.

Why 1e-7 and not test_torch_glasso.py's 1e-9: from the second step on the
iterative buckets start warm, W0 = inv(T0) with T0 the previous solution,
and torch's batched inverse and ``jnp.linalg.inv`` may differ in the last
ulp; BCD then carries that difference through its sweeps and may stop one
sweep apart.  The cases solve at tol 1e-9 (TIGHT), so a one-sweep
difference moves Theta by ~1e-9 times the block's scale, well inside 1e-7.
Sweep counts are held equal where ``test_warm_lanes_stop_at_the_reference_
sweeps`` shows them equal: each recorded launch, warm lanes included,
replayed through the reference's plain kernel on the same inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro.core import glasso_path as jax_glasso_path
from repro.core.instrument import counts as jax_counts, reset as jax_reset
from repro.core.solvers.kkt import kkt_residual
from repro.engine import EngineOptions as JaxOptions
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.sparse import SparseTheta
from repro_torch.covariance import sample_covariance, structured_synthetic
from repro_torch.engine.planner import bucket_key, component_lifetimes, plan_path

THETA_ATOL = 1e-7
WARM_COLD_ATOL = 1e-5
# tests/test_torch_float32.py's bcd tolerance for float32 solves
F32_ATOL = 1e-9
TIGHT = JaxOptions(solver_opts={"tol": 1e-9})
COUNTERS = ("planner.", "select.warm.", "partition.unionfind_passes", "router.")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_options(jopts: JaxOptions, **kw) -> EngineOptions:
    return EngineOptions.from_reference(dataclasses.asdict(jopts), device="cpu", **kw)


def _kkt(S, Theta, lam):
    if isinstance(Theta, SparseTheta):
        Theta = Theta.toarray()
    return float(kkt_residual(jnp.asarray(S), jnp.asarray(Theta), lam, zero_tol=1e-12))


def _paths(S, lams, jopts=TIGHT, *, X=None, **kw):
    """Both packages' paths from one options value, every counter reset
    just before each; returns (port, reference, reference counters)."""
    jax_reset("")
    if X is None:
        ref = jax_glasso_path(S, lams, options=jopts, **kw)
    else:
        ref = jax_glasso_path(X=X, lambdas=lams, from_data=True, options=jopts, **kw)
    jc = jax_counts("")
    instrument.reset("")
    topts = _port_options(jopts)
    if X is None:
        got = repro_torch.glasso_path(S, lams, options=topts, **kw)
    else:
        got = repro_torch.glasso_path(X=X, lambdas=lams, from_data=True, options=topts, **kw)
    return got, ref, jc


def _assert_same_path(got, ref, jc, S, *, atol=THETA_ATOL, prefixes=COUNTERS):
    """Step by step equality with the reference.  Where the reference's
    warm BCD returned a non-finite Theta (``test_diverged_warm_lane_is_
    resolved_cold``), the port's step must instead be finite and pass the
    KKT check; its one extra counter, ``router.fallback.warm``, is left out
    of the counter comparison."""
    assert [r.lam for r in got] == [r.lam for r in ref]
    bound = None if S is None else 1e-5 * max(1.0, float(np.abs(S).max()))
    for g, r in zip(got, ref):
        assert np.array_equal(g.labels, r.labels)
        assert g.route_mix == r.route_mix
        assert g.oversize == r.oversize
        gt = g.Theta.toarray() if isinstance(g.Theta, SparseTheta) else g.Theta
        rt = r.Theta.toarray() if hasattr(r.Theta, "toarray") else np.asarray(r.Theta)
        assert np.isfinite(gt).all()
        if np.isfinite(rt).all():
            np.testing.assert_allclose(gt, rt, rtol=0, atol=atol)
            if bound is not None:
                assert _kkt(S, r.Theta, r.lam) <= bound
        if bound is not None:
            assert _kkt(S, g.Theta, g.lam) <= bound
    for prefix in prefixes:
        want = {k: v for k, v in jc.items() if k.startswith(prefix)}
        have = {k: v for k, v in instrument.counts(prefix).items()
                if k != "router.fallback.warm"}
        assert have == want, prefix


def _dyadic_merging_covariance():
    """PD covariance with exactly representable edge weights and a known
    merge: two 4-cliques at |S_ij| = 0.5 joined by one 0.25 cross edge
    (tests/test_select.py's)."""
    S = np.eye(8)
    for block in (range(0, 4), range(4, 8)):
        for i in block:
            for j in block:
                if i != j:
                    S[i, j] = 0.5
    S[3, 4] = S[4, 3] = 0.25
    return S


# ---------------------------------------------------------------- dense S


@pytest.mark.parametrize("K,p1,seed", [(6, 6, 0), (4, 10, 1)])
def test_structured_path_matches_reference(K, p1, seed):
    """Every rung of the ladder along a 5-point grid: singletons, pairs,
    trees, chordal and general blocks, merges between steps."""
    S = structured_synthetic(K, p1, seed=seed)
    lams = [0.9, 0.75, 0.6, 0.45, 0.3]
    got, ref, jc = _paths(S, lams)
    _assert_same_path(got, ref, jc, S)
    assert jc["partition.unionfind_passes"] == 1
    assert jc.get("planner.buckets_reused", 0) > 0
    warm = {k: v for k, v in jc.items() if k.startswith("select.warm.")}
    assert warm.get("select.warm.merged", 0) + warm.get("select.warm.reused", 0) > 0


@pytest.mark.parametrize("p,seed", [(14, 0), (24, 3), (32, 5)])
def test_random_path_matches_reference(p, seed):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lams = [lambda_between_edges(S, q) for q in (0.97, 0.9, 0.8, 0.65, 0.5)]
    got, ref, jc = _paths(S, lams)
    _assert_same_path(got, ref, jc, S)


@pytest.mark.parametrize("route", [True, False])
def test_default_tolerance_path_matches_reference(route):
    """The engine's default solver tolerance, routed and unrouted (every
    bucket iterative, so every bucket is counted in select.warm.*)."""
    S = structured_synthetic(5, 8, seed=2)
    got, ref, jc = _paths(S, [0.8, 0.6, 0.4], JaxOptions(route=route))
    _assert_same_path(got, ref, jc, S, atol=1e-6)


def test_warm_lanes_stop_at_the_reference_sweeps(monkeypatch):
    """Every bucket_glasso launch of a port path, warm (W0, T0) lanes
    included, recorded and replayed through the reference's plain kernel
    (``repro.kernels.bucket_glasso.ref.fused_bcd_ref_stack``) on the same
    inputs: sweep counts equal lane by lane, Theta within 1e-12.  A warm
    path needs no more sweeps than the cold one, and equals it within
    WARM_COLD_ATOL."""
    from repro.kernels.bucket_glasso.ref import fused_bcd_ref_stack as jax_ref_stack
    from repro_torch.core.solvers import bcd as bcd_mod

    S = structured_synthetic(6, 6, seed=0)
    lams = [0.9, 0.75, 0.6, 0.45]
    calls: list = []
    inner = bcd_mod.fused_bcd_stack

    def recording(*args, **kwargs):
        theta, sw = inner(*args, **kwargs)
        calls.append((args, kwargs, theta, sw))
        return theta, sw

    monkeypatch.setattr(bcd_mod, "fused_bcd_stack", recording)
    warm = repro_torch.glasso_path(S, lams, options=_port_options(TIGHT))
    n_warm = len(calls)
    cold = repro_torch.glasso_path(S, lams, warm_start=False, options=_port_options(TIGHT))
    assert n_warm == len(calls) - n_warm > 0
    n_warm_lanes = 0
    for args, kwargs, theta, sw in calls:
        want, want_sw = jax_ref_stack(*(jnp.asarray(a.numpy()) for a in args), **kwargs)
        np.testing.assert_array_equal(sw.numpy(), np.asarray(want_sw))
        np.testing.assert_allclose(theta.numpy(), np.asarray(want), rtol=0, atol=1e-12)
        n_warm_lanes += int((args[4].diagonal(dim1=1, dim2=2) != 1).any(dim=1).sum())
    assert n_warm_lanes > 0
    sweeps = [int(c[3].sum()) for c in calls]
    assert sum(sweeps[:n_warm]) <= sum(sweeps[n_warm:])
    for w, c in zip(warm, cold):
        np.testing.assert_allclose(w.Theta, c.Theta, rtol=0, atol=WARM_COLD_ATOL)


# ------------------------------------------------------- warm == cold, ties


def test_warm_equals_cold_with_tie_and_merge():
    """A grid whose lambdas are existing |S_ij| values (strict-threshold
    ties: the tied edge is excluded) with a merge in the middle: the warm
    path equals cold single solves and the warm_start=False path, and the
    reference's path."""
    S = _dyadic_merging_covariance()
    iu = np.triu_indices(8, 1)
    vals = np.unique(np.abs(S[iu]))
    ties = [float(v) for v in vals[vals > 0]]          # 0.25 and 0.5
    lams = sorted(ties + [0.375, 0.125], reverse=True)  # merge below 0.25
    opts = _port_options(TIGHT)
    warm = repro_torch.glasso_path(S, lams, options=opts)
    cold_path = repro_torch.glasso_path(S, lams, warm_start=False, options=opts)
    assert [int(r.screen.n_components) for r in warm] == [8, 2, 2, 1]
    for w, c in zip(warm, cold_path):
        single = repro_torch.glasso(S, w.lam, options=opts)
        assert np.array_equal(w.labels, single.labels)
        np.testing.assert_allclose(w.Theta, single.Theta, rtol=0, atol=WARM_COLD_ATOL)
        np.testing.assert_allclose(w.Theta, c.Theta, rtol=0, atol=WARM_COLD_ATOL)
    got, ref, jc = _paths(S, lams)
    _assert_same_path(got, ref, jc, S)


@pytest.mark.parametrize("seed", [0, 1])
def test_warm_equals_cold_at_existing_values(seed):
    """Integer-valued S over a power of two: every |S_ij| is exact, and the
    grid holds two of them (ties) around a merge."""
    rng = np.random.default_rng(seed)
    p = 18
    A = rng.integers(-4, 5, size=(p, p)).astype(np.float64)
    S = (A + A.T) / 16.0
    np.fill_diagonal(S, np.abs(S).sum(axis=1) + 1.0)
    iu = np.triu_indices(p, 1)
    vals = np.unique(np.abs(S[iu]))
    vals = vals[vals > 0]
    lams = [float(vals[-1]) + 0.1, float(vals[-1]), float(vals[-2]), float(vals[-3])]
    opts = _port_options(TIGHT)
    warm = repro_torch.glasso_path(S, lams, options=opts)
    comps = [int(r.screen.n_components) for r in warm]
    assert comps[0] == p and comps[-1] < comps[1]  # singletons, then merges
    for w in warm:
        cold = repro_torch.glasso(S, w.lam, options=opts)
        np.testing.assert_allclose(w.Theta, cold.Theta, rtol=0, atol=WARM_COLD_ATOL)
    got, ref, jc = _paths(S, lams)
    _assert_same_path(got, ref, jc, S)


# ----------------------------------------------------------- grid handling


@pytest.mark.parametrize("screen", [True, False])
def test_unsorted_and_duplicated_grids_normalize_identically(screen):
    rng = np.random.default_rng(7)
    S = random_covariance(rng, 10)
    lams = [lambda_between_edges(S, q) for q in (0.3, 0.6, 0.8)]
    messy = [lams[0], lams[2], lams[1], lams[0]]
    canon = sorted(lams, reverse=True)
    opts = _port_options(TIGHT)
    a = repro_torch.glasso_path(S, messy, screen=screen, options=opts)
    b = repro_torch.glasso_path(S, canon, screen=screen, options=opts)
    ref = jax_glasso_path(S, messy, screen=screen, options=TIGHT)
    assert [r.lam for r in a] == [r.lam for r in ref] == canon
    for ra, rb, rr in zip(a, b, ref):
        np.testing.assert_array_equal(ra.Theta, rb.Theta)
        np.testing.assert_allclose(ra.Theta, np.asarray(rr.Theta), rtol=0, atol=THETA_ATOL)


def test_screen_false_matches_reference():
    rng = np.random.default_rng(4)
    S = random_covariance(rng, 12)
    lams = [lambda_between_edges(S, q) for q in (0.9, 0.6, 0.3)]
    got, ref, _ = _paths(S, lams, screen=False)
    assert all(r.screen is None for r in got)
    _assert_same_path(got, ref, {}, S, prefixes=())
    assert all(r.route_mix == {"general": 1} for r in got)


def test_grid_errors_match_reference():
    S = random_covariance(np.random.default_rng(0), 6)
    cases = [dict(lambdas=[0.5, -0.1]), dict(lambdas=[0.5, 0.0], screen=False),
             dict(lambdas=[]), dict(lambdas=[np.nan])]
    for kw in cases:
        with pytest.raises(ValueError) as e_ref:
            jax_glasso_path(S, **kw)
        with pytest.raises(ValueError) as e_port:
            repro_torch.glasso_path(S, options=EngineOptions(device="cpu"), **kw)
        assert str(e_port.value) == str(e_ref.value)


# ------------------------------------------------------------ the planner


def test_plan_path_matches_reference_planner():
    """Labels, lifetimes, bucket keys and reused keys of every step equal the
    reference planner's."""
    from repro.engine.planner import bucket_key as jax_bucket_key
    from repro.engine.planner import plan_path as jax_plan_path

    S = structured_synthetic(6, 8, seed=4)
    lams = [0.9, 0.7, 0.55, 0.4, 0.3]
    ours = plan_path(S, lams)
    theirs = jax_plan_path(S, lams)
    assert ours.lambdas == theirs.lambdas
    for a, b in zip(ours.steps, theirs.steps):
        assert np.array_equal(a.labels, b.labels)
        assert [bucket_key(x) for x in a.plan.buckets] == [jax_bucket_key(x) for x in b.plan.buckets]
        assert a.reused_keys == b.reused_keys
        assert (a.screen.n_components, a.screen.n_edges, a.screen.max_comp) == (
            b.screen.n_components, b.screen.n_edges, b.screen.max_comp)
        for x, y in zip(a.plan.buckets, b.plan.buckets):
            np.testing.assert_array_equal(x.blocks, np.asarray(y.blocks))
    life = component_lifetimes([s.labels for s in ours.steps])
    assert all(0 <= b <= d < len(lams) for b, d in life.values())


def test_reused_bucket_keeps_its_device_stack():
    """A bucket the planner carried over skips the upload: the executor
    hands the solver the same stack object it kept from the previous
    step; keep_solutions=False frees the kept state."""
    from repro_torch.engine.api import Engine

    S = structured_synthetic(6, 6, seed=0)
    eng = Engine(options=_port_options(TIGHT))
    path = plan_path(S, [0.9, 0.75, 0.6])
    eng._execute_path(S, path, warm_start=True, p_max=None)
    ex = eng.executor
    last = path.steps[-1]
    kept = {bucket_key(b) for b in last.plan.buckets if b.blocks is not None}
    assert set(ex._prev_blocks) <= kept and ex._prev_solutions
    assert all(isinstance(v, torch.Tensor) for v in ex._prev_solutions.values())
    ex.solve_plan(last.plan, last.lam, S)
    assert not ex._prev_solutions and not ex._prev_blocks


# ---------------------------------------------------------- sparse output


@pytest.mark.parametrize("route", [True, False])
def test_sparse_path_equals_dense_path_bitwise(route):
    S = structured_synthetic(6, 6, seed=1)
    lams = [0.9, 0.7, 0.5, 0.35]
    base = _port_options(TIGHT).replace(route=route)
    dense = repro_torch.glasso_path(S, lams, options=base.replace(output="dense"))
    sparse = repro_torch.glasso_path(S, lams, options=base.replace(output="sparse"))
    for d, s in zip(dense, sparse):
        assert isinstance(s.Theta, SparseTheta) and s.output == "sparse"
        np.testing.assert_array_equal(s.Theta.toarray(), d.Theta)
        for c, blk in s.Theta.blocks():
            np.testing.assert_array_equal(blk, d.Theta[np.ix_(c, c)])
        assert s.route_mix == d.route_mix


# --------------------------------------------------------------- from data


def _factor_data(n=64, p=30, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, 3))
    load = np.zeros((3, p))
    for g in range(3):
        load[g, g * 8: g * 8 + 8] = rng.uniform(0.6, 1.0, 8)
    return F @ load + 0.5 * rng.standard_normal((n, p))


@pytest.mark.parametrize("seed,tile", [(0, 8), (2, 16)])
def test_from_data_path_matches_reference_and_dense(seed, tile):
    """Each step's blocks stay at most ~16 wide (q >= 0.85): the wide
    merged block of a lower lambda costs the CPU plain version seconds a
    solve, and ``test_diverged_warm_lane_is_resolved_cold`` drives it."""
    X = _factor_data(seed=seed)
    S = sample_covariance(X, device="cpu").numpy()
    lams = [lambda_between_edges(S, q) for q in (0.98, 0.94, 0.9, 0.85)]
    stream = {"tile": tile, "chunk": 16}
    got, ref, jc = _paths(None, lams, X=X, stream=stream)
    _assert_same_path(got, ref, jc, S, prefixes=COUNTERS + ("stream.tiles",))
    assert instrument.count("stream.tiles_total") > 0
    dense = repro_torch.glasso_path(S, lams, options=_port_options(TIGHT))
    for g, d in zip(got, dense):
        assert np.array_equal(g.labels, d.labels)
        assert g.route_mix == d.route_mix
        np.testing.assert_allclose(g.Theta, d.Theta, rtol=0, atol=THETA_ATOL)


def test_diverged_warm_lane_is_resolved_cold():
    """A grid with a large last drop in lambda (0.469 -> 0.111): the
    reference's warm BCD lane of the merged b = 26 block returns NaN there
    (its W0 = inv(T0) is dual-feasible only for the previous lambda), from
    S and from X alike.  The port re-solves that lane cold: finite, KKT,
    equal to a single cold solve, one ``router.fallback.warm``."""
    X = _factor_data(seed=1)
    S = sample_covariance(X, device="cpu").numpy()
    lams = [lambda_between_edges(S, q) for q in (0.98, 0.93, 0.85, 0.7)]
    ref = jax_glasso_path(S, lams, options=TIGHT)
    assert [bool(np.isfinite(np.asarray(r.Theta)).all()) for r in ref] == [True] * 3 + [False]
    instrument.reset("")
    got = repro_torch.glasso_path(S, lams, options=_port_options(TIGHT))
    assert instrument.count("router.fallback.warm") == 1
    cold = repro_torch.glasso(S, lams[-1], options=_port_options(TIGHT))
    np.testing.assert_allclose(got[-1].Theta, cold.Theta, rtol=0, atol=WARM_COLD_ATOL)
    assert _kkt(S, got[-1].Theta, lams[-1]) <= 1e-5 * max(1.0, float(np.abs(S).max()))


def test_from_data_path_argument_errors_match_reference():
    X = np.random.default_rng(0).standard_normal((8, 5))
    cases = [dict(S=X, X=X, lambdas=[0.1]), dict(from_data=True, lambdas=[0.1]),
             dict(X=X), dict(S=X), dict(X=X, lambdas=[0.5, 0.0])]
    for kw in cases:
        with pytest.raises(ValueError) as e_ref:
            jax_glasso_path(**kw)
        with pytest.raises(ValueError) as e_port:
            repro_torch.glasso_path(**kw, options=EngineOptions(device="cpu"))
        assert str(e_port.value) == str(e_ref.value)


# --------------------------------------------------------------- oversize


def test_oversize_path_reuses_and_warm_starts_the_giant_bucket(monkeypatch):
    """The sharded route at d = 1 along a path whose two lambdas cross no
    |S_ij|: the oversize bucket is reused, its sharded solve warm-starts
    from the previous block, and its outer iterations equal the
    reference's at every step (and drop at the second)."""
    import repro.core.solvers.sharded as jax_sharded_mod
    import repro_torch.core.solvers.sharded as sharded_mod

    rng = np.random.default_rng(3)
    S = random_covariance(rng, 22)
    iu = np.triu_indices(22, 1)
    vals = np.unique(np.abs(S[iu]))
    k = int(0.3 * vals.size)
    lams = [float(vals[k] + 0.75 * (vals[k + 1] - vals[k])),
            float(vals[k] + 0.25 * (vals[k + 1] - vals[k]))]
    iters = {"port": [], "ref": []}
    for mod, tag in ((sharded_mod, "port"), (jax_sharded_mod, "ref")):
        inner = mod.glasso_sharded

        def recording(*args, _inner=inner, _tag=tag, **kwargs):
            res = _inner(*args, **kwargs)
            iters[_tag].append((res.iters, kwargs.get("Theta0") is not None))
            return res

        monkeypatch.setattr(mod, "glasso_sharded", recording)
    jopts = JaxOptions(solver="admm", oversize_threshold=8, solver_opts={"tol": 1e-9})
    got, ref, jc = _paths(S, lams, jopts)
    _assert_same_path(got, ref, jc, S, atol=1e-8,
                      prefixes=COUNTERS + ("solver.oversize.dispatched", "solver.oversize.fallbacks"))
    assert iters["port"] == iters["ref"]
    assert [w for _, w in iters["port"]] == [False, True]
    assert iters["port"][1][0] < iters["port"][0][0]
    assert jc["planner.buckets_reused"] >= 1 and jc["select.warm.reused"] >= 1
    assert all(r.route_mix.get("oversize", 0) == 1 and r.oversize["fallbacks"] == 0 for r in got)


# ----------------------------------------------------------------- float32


def test_float32_path_matches_reference():
    S = structured_synthetic(6, 6, seed=0)
    lams = [0.9, 0.7, 0.55, 0.4]
    jopts = JaxOptions(dtype="float32")
    got, ref, jc = _paths(S, lams, jopts)
    _assert_same_path(got, ref, jc, None, atol=F32_ATOL)
    assert [r.Theta.dtype for r in got] == [np.asarray(r.Theta).dtype for r in ref]
    assert got[-1].Theta.dtype == np.float32


# ------------------------------------------------------------------ device


def test_path_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """Without a card the path and the selection layer raise, as glasso
    does, from S and from X; ``device="cpu"`` runs them."""
    from repro_torch.select import select_path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S = structured_synthetic(2, 4, seed=0)
    X = _factor_data(n=16, p=24)
    calls = [lambda: repro_torch.glasso_path(S, [0.5, 0.3]),
             lambda: repro_torch.glasso_path(X=X, lambdas=[0.5], from_data=True),
             lambda: select_path(S, grid=[0.5, 0.3], n=20)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    res = repro_torch.glasso_path(S, [0.5, 0.3], options=EngineOptions(device="cpu"))
    assert all(r.device == "cpu" and np.isfinite(r.Theta).all() for r in res)
