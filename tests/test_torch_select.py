"""The port's model selection (``repro_torch.select``) against the reference
package's ``repro.select``: the grid helpers, the warm homotopy path and its
``select.warm.*`` accounting, the per-component criteria, and
``select_path`` with EBIC, k-fold CV and StARS.  Mirrors
tests/test_select.py (its ``PathSpec`` serving cases wait for the port's
serving layer).

Tolerances: the paths run at tol 1e-9 (TIGHT) and their Thetas agree with
the reference's within 1e-7 (tests/test_torch_path.py says why); the
criteria are sums of per-block log-determinants and traces of those
Thetas, so scores agree within SCORE_RTOL = 1e-8 relative.  The selected
index, the support sizes, the component counts, the route mixes and the
warm counters are held equal exactly.  CV folds and StARS subsamples are
drawn by ``np.random.default_rng(seed)`` in both packages, so the same
seed draws the same rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro import select as jax_select
from repro.core import glasso as jax_glasso
from repro.core.instrument import reset as jax_reset, tail_counts as jax_tail
from repro.engine import EngineOptions as JaxOptions
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.engine.registry import available_cc_backends
from repro_torch.select import (
    CRITERIA,
    CovSource,
    Selection,
    SelectionReport,
    ebic_score,
    gaussian_loglik,
    homotopy_path,
    kfold_cv,
    lambda_grid,
    lambda_max,
    lambda_max_from_data,
    loglik_terms,
    normalize_lambda_grid,
    select_path,
    stars,
    warm_counts,
)

JAX_TIGHT = JaxOptions(solver_opts={"tol": 1e-9})
TIGHT = EngineOptions.from_reference(dataclasses.asdict(JAX_TIGHT), device="cpu")
THETA_ATOL = 1e-7
SCORE_RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dyadic_merging_covariance():
    """Two 4-cliques at |S_ij| = 0.5 joined by one 0.25 cross edge:
    grid points AT 0.5 and 0.25 are strict-threshold ties."""
    S = np.eye(8)
    for block in (range(0, 4), range(4, 8)):
        for i in block:
            for j in block:
                if i != j:
                    S[i, j] = 0.5
    S[3, 4] = S[4, 3] = 0.25
    return S


def _factor_data(n, p, seed):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, 2))
    load = np.zeros((2, p))
    load[0, :4] = 0.9
    load[1, 4:8] = 0.8
    return F @ load + 0.6 * rng.standard_normal((n, p))


# -- grid -------------------------------------------------------------------


def test_normalize_sorts_descending_and_dedupes():
    assert normalize_lambda_grid([0.1, 0.5, 0.3, 0.5, 0.1]) == [0.5, 0.3, 0.1]


@pytest.mark.parametrize("bad", [[], [0.5, 0.0], [0.5, -1.0], [np.nan], [np.inf]])
def test_normalize_rejects_degenerate_grids_as_reference(bad):
    with pytest.raises(ValueError) as e_ref:
        jax_select.normalize_lambda_grid(bad)
    with pytest.raises(ValueError) as e_port:
        normalize_lambda_grid(bad)
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("n,p,tile", [(40, 23, 8), (33, 17, 4), (20, 9, 16)])
def test_lambda_max_from_data_matches_reference(n, p, tile):
    X = np.random.default_rng(p).standard_normal((n, p))
    S = np.cov(X, rowvar=False, bias=True)
    cfg = {"tile": tile, "chunk": 16}
    jax_reset("select.grid.")
    want = jax_select.lambda_max_from_data(X, config=cfg)
    instrument.reset("select.grid.")
    got = lambda_max_from_data(X, config=cfg)
    assert got == want
    assert got == pytest.approx(lambda_max(S), rel=1e-12)
    assert instrument.tail_counts("select.grid.") == jax_tail("select.grid.")
    n_tiles = -(-p // tile)
    c = instrument.tail_counts("select.grid.")
    assert c.get("tiles_scanned", 0) + c.get("tiles_pruned", 0) == n_tiles * (n_tiles + 1) // 2


def test_lambda_grid_matches_reference():
    rng = np.random.default_rng(1)
    S = random_covariance(rng, 9)
    assert lambda_max(S) == jax_select.lambda_max(S)
    for kw in (dict(n_points=7), dict(n_points=5, scale="linear", lam_min_ratio=0.5),
               dict(n_points=1)):
        assert lambda_grid(S, **kw) == jax_select.lambda_grid(S, **kw)
    grid = lambda_grid(S, n_points=7)
    assert grid[0] == pytest.approx(lambda_max(S)) and grid == sorted(grid, reverse=True)
    X = rng.standard_normal((30, 11))
    assert lambda_grid(X=X, n_points=4, config={"tile": 4}) == jax_select.lambda_grid(
        X=X, n_points=4, config={"tile": 4})
    for kw in (dict(X=np.zeros((3, 3))), dict(scale="sqrt"), dict(n_points=0),
               dict(lam_min_ratio=1.5)):
        with pytest.raises(ValueError) as e_ref:
            jax_select.lambda_grid(S, **kw)
        with pytest.raises(ValueError) as e_port:
            lambda_grid(S, **kw)
        assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match="lambda_max is 0"):
        lambda_grid(np.eye(4))


# -- homotopy ------------------------------------------------------------------


@pytest.mark.parametrize("backend", available_cc_backends())
def test_homotopy_matches_cold_solves_with_ties_and_merge(backend):
    """0.5: a tie on every clique edge -> all singletons; 0.375: two
    cliques; 0.25: a tie on the cross edge -> still two; 0.125: merged."""
    S = _dyadic_merging_covariance()
    lams = [0.5, 0.375, 0.25, 0.125]
    opts = TIGHT.replace(cc_backend=backend)
    path = homotopy_path(S, lambdas=lams, options=opts)
    ref = jax_select.homotopy_path(S, lambdas=lams, options=JAX_TIGHT.replace(cc_backend=backend))
    counts = []
    for r, rr, lam in zip(path, ref, lams):
        cold = repro_torch.glasso(S, lam, options=opts)
        np.testing.assert_array_equal(r.labels, cold.labels)
        np.testing.assert_allclose(r.Theta, cold.Theta, atol=10 * opts.route_check_tol)
        np.testing.assert_array_equal(r.labels, rr.labels)
        np.testing.assert_allclose(r.Theta, np.asarray(rr.Theta), rtol=0, atol=THETA_ATOL)
        counts.append(int(r.screen.n_components))
    assert counts == [8, 2, 2, 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_homotopy_matches_cold_on_generic_covariance(seed):
    S = random_covariance(np.random.default_rng(seed), 14)
    lams = [lambda_between_edges(S, q) for q in (0.85, 0.6, 0.4, 0.2)]
    path = homotopy_path(S, lambdas=lams, options=TIGHT)
    for r in path:
        cold = repro_torch.glasso(S, r.lam, options=TIGHT)
        np.testing.assert_allclose(r.Theta, cold.Theta, atol=1e-5)


def test_homotopy_from_data_matches_reference():
    X = _factor_data(48, 12, seed=3)
    grid = [0.6, 0.45, 0.3]
    got = homotopy_path(X=X, lambdas=grid, options=TIGHT, stream={"tile": 4})
    ref = jax_select.homotopy_path(X=X, lambdas=grid, options=JAX_TIGHT, stream={"tile": 4})
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.Theta, np.asarray(r.Theta), rtol=0, atol=THETA_ATOL)
    with pytest.raises(ValueError, match="exactly one of S or X="):
        homotopy_path(lambdas=grid, options=TIGHT)


# -- warm accounting ---------------------------------------------------------


@pytest.mark.parametrize("route", [False, True])
def test_warm_counters_classify_reused_merged_cold(route):
    """route=False makes every bucket solver-bound, so every one is counted;
    the counts equal the reference's in both arms."""
    S = _dyadic_merging_covariance()
    lams = [0.375, 0.3, 0.125]  # cliques, unchanged cliques, merged
    jopts = JaxOptions(route=route, solver_opts={"tol": 1e-8})
    opts = EngineOptions.from_reference(dataclasses.asdict(jopts), device="cpu")
    for warm_start in (True, False):
        jax_reset("select.warm.")
        jax_select.homotopy_path(S, lambdas=lams, options=jopts, warm_start=warm_start)
        instrument.reset("select.warm.")
        homotopy_path(S, lambdas=lams, options=opts, warm_start=warm_start)
        assert warm_counts() == jax_select.warm_counts()
    instrument.reset("select.warm.")
    homotopy_path(S, lambdas=lams, options=opts.replace(route=False))
    warm = warm_counts()
    assert warm.get("cold", 0) >= 1 and warm.get("reused", 0) >= 1 and warm.get("merged", 0) >= 1
    instrument.reset("select.warm.")
    homotopy_path(S, lambdas=lams, options=opts.replace(route=False), warm_start=False)
    warm = warm_counts()
    assert set(warm) <= {"cold"} and warm.get("cold", 0) >= 3


# -- criteria ---------------------------------------------------------------


@pytest.mark.parametrize("seed,gamma", [(0, 0.5), (2, 0.0), (4, 1.0)])
def test_loglik_and_ebic_match_manual_and_reference(seed, gamma):
    S = random_covariance(np.random.default_rng(seed), 12)
    lam = lambda_between_edges(S, 0.5)
    res = repro_torch.glasso(S, lam, options=TIGHT)
    ref = jax_glasso(S, lam, options=JAX_TIGHT)
    src = CovSource(S=S)
    ld, tr = loglik_terms(res, src)
    sign, manual_ld = np.linalg.slogdet(res.Theta)
    assert sign > 0
    assert ld == pytest.approx(manual_ld, rel=1e-10)
    assert tr == pytest.approx(float(np.sum(S * res.Theta)), rel=1e-10)
    n = 80
    E = res.support_edges().shape[0]
    manual = -n * (manual_ld - np.sum(S * res.Theta)) + E * (
        np.log(n) + 4 * gamma * np.log(S.shape[0]))
    assert ebic_score(res, src, n, gamma=gamma) == pytest.approx(manual)
    assert gaussian_loglik(res, src, n) == pytest.approx(0.5 * n * (ld - tr))
    want = jax_select.ebic_score(ref, jax_select.CovSource(S=S), n, gamma=gamma)
    assert ebic_score(res, src, n, gamma=gamma) == pytest.approx(want, rel=SCORE_RTOL)
    for bad, kw in ((0, {}), (None, {}), (n, {"gamma": -1.0})):
        with pytest.raises(ValueError) as e_ref:
            jax_select.ebic_score(ref, jax_select.CovSource(S=S), bad, **kw)
        with pytest.raises(ValueError) as e_port:
            ebic_score(res, src, bad, **kw)
        assert str(e_port.value) == str(e_ref.value)


def test_criteria_agree_dense_vs_sparse_output():
    S = random_covariance(np.random.default_rng(5), 12)
    lam = lambda_between_edges(S, 0.5)
    dense = repro_torch.glasso(S, lam, options=TIGHT.replace(output="dense"))
    sparse = repro_torch.glasso(S, lam, options=TIGHT.replace(output="sparse"))
    src = CovSource(S=S)
    ld_d, tr_d = loglik_terms(dense, src)
    ld_s, tr_s = loglik_terms(sparse, src)
    assert ld_s == pytest.approx(ld_d, rel=1e-8)
    assert tr_s == pytest.approx(tr_d, rel=1e-8)
    assert ebic_score(sparse, src, 50) == pytest.approx(ebic_score(dense, src, 50), rel=1e-8)


def test_cov_source_from_data_matches_covariance_and_reference():
    X = np.random.default_rng(6).standard_normal((50, 10))
    S = np.cov(X, rowvar=False, bias=True)
    src = CovSource(X=X)
    ref = jax_select.CovSource(X=X)
    idx = np.array([1, 4, 7])
    np.testing.assert_allclose(src.block(idx), S[np.ix_(idx, idx)], atol=1e-12)
    np.testing.assert_allclose(src.diag(idx), np.diag(S)[idx], atol=1e-12)
    np.testing.assert_array_equal(src.block(idx), ref.block(idx))
    np.testing.assert_array_equal(src.diag(idx), ref.diag(idx))
    assert src.p == ref.p == 10 and src.n == 50
    for kw in ({}, {"S": S, "X": X}):
        with pytest.raises(ValueError) as e_ref:
            jax_select.CovSource(**kw)
        with pytest.raises(ValueError) as e_port:
            CovSource(**kw)
        assert str(e_port.value) == str(e_ref.value)


# -- select_path ------------------------------------------------------------


def _assert_same_selection(got: Selection, ref, *, rtol=SCORE_RTOL):
    a, b = got.report, ref.report
    assert a.criterion == b.criterion and a.lambdas == b.lambdas
    assert a.selected_index == b.selected_index
    np.testing.assert_allclose(a.scores, b.scores, rtol=rtol, atol=0)
    assert a.support_sizes == b.support_sizes
    assert a.n_components == b.n_components
    assert a.route_mixes == b.route_mixes
    assert a.warm == b.warm
    assert got.result is got.path[a.selected_index]
    for st in a.stages_us:
        assert set(st) == {"screen_us", "solve_us", "dispatch_us", "assemble_us"}


@pytest.mark.parametrize("seed,grid", [(0, 5), (3, {"auto": 4})])
def test_select_path_ebic_matches_reference(seed, grid):
    S = random_covariance(np.random.default_rng(seed), 12)
    jax_reset("")
    ref = jax_select.select_path(S, grid=grid, criterion="ebic", n=100, options=JAX_TIGHT)
    instrument.reset("")
    sel = select_path(S, grid=grid, criterion="ebic", n=100, options=TIGHT)
    assert isinstance(sel, Selection) and isinstance(sel.report, SelectionReport)
    _assert_same_selection(sel, ref)
    rep = sel.report
    assert rep.scores[rep.selected_index] == min(rep.scores)
    assert rep.detail == ref.report.detail == {"gamma": 0.5, "n": 100}
    assert rep.warm_fraction == ref.report.warm_fraction
    assert rep.selected_lam == rep.lambdas[rep.selected_index]


def test_select_path_ebic_from_data_matches_reference():
    X = _factor_data(60, 10, seed=1)
    kw = dict(grid=[0.6, 0.4, 0.25], criterion="ebic", criterion_opts={"gamma": 0.25})
    ref = jax_select.select_path(X=X, options=JAX_TIGHT, **kw)
    sel = select_path(X=X, options=TIGHT, **kw)
    _assert_same_selection(sel, ref)
    assert sel.report.detail == {"gamma": 0.25, "n": 60}


@pytest.mark.parametrize("k,seed", [(3, 0), (4, 2)])
def test_select_path_cv_matches_reference(k, seed):
    X = _factor_data(60, 10, seed=seed)
    kw = dict(grid=[0.6, 0.4, 0.25], criterion="cv", criterion_opts={"k": k, "seed": seed})
    ref = jax_select.select_path(X=X, options=JAX_TIGHT, **kw)
    instrument.reset("select.cv.")
    sel = select_path(X=X, options=TIGHT, **kw)
    _assert_same_selection(sel, ref)
    assert sel.report.scores[sel.report.selected_index] == max(sel.report.scores)
    assert sel.report.detail == ref.report.detail == {"k": k, "seed": seed}
    assert instrument.count("select.cv.folds") == k


@pytest.mark.parametrize("n_sub,seed", [(4, 0), (3, 5)])
def test_select_path_stars_matches_reference(n_sub, seed):
    X = _factor_data(60, 10, seed=seed)
    kw = dict(grid=[0.6, 0.4, 0.25], criterion="stars",
              criterion_opts={"n_subsamples": n_sub, "seed": seed})
    ref = jax_select.select_path(X=X, options=JAX_TIGHT, **kw)
    sel = select_path(X=X, options=TIGHT, **kw)
    _assert_same_selection(sel, ref)
    assert sel.report.detail == ref.report.detail
    mono = sel.report.detail["monotone"]
    assert all(a <= b + 1e-12 for a, b in zip(mono, mono[1:]))
    assert all(0.0 <= d <= 0.5 + 1e-12 for d in sel.report.scores)


def test_kfold_cv_and_stars_direct_match_reference():
    X = np.random.default_rng(9).standard_normal((45, 8))
    got = kfold_cv(X, [0.5, 0.3], k=3, seed=1, options=TIGHT)
    want = jax_select.kfold_cv(X, [0.5, 0.3], k=3, seed=1, options=JAX_TIGHT)
    assert got["selected_index"] == want["selected_index"] and got["k"] == 3
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=SCORE_RTOL)
    got = stars(X, [0.5, 0.3], n_subsamples=3, seed=1, options=TIGHT)
    want = jax_select.stars(X, [0.5, 0.3], n_subsamples=3, seed=1, options=JAX_TIGHT)
    assert got == want
    cases = [(kfold_cv, jax_select.kfold_cv, {"k": 1}),
             (stars, jax_select.stars, {"n_subsamples": 1}),
             (stars, jax_select.stars, {"beta": 1.5})]
    for port_fn, ref_fn, kw in cases:
        with pytest.raises(ValueError) as e_ref:
            ref_fn(X, [0.5], options=JAX_TIGHT, **kw)
        with pytest.raises(ValueError) as e_port:
            port_fn(X, [0.5], options=TIGHT, **kw)
        assert str(e_port.value) == str(e_ref.value)


def test_select_path_validates_inputs_as_reference():
    S = random_covariance(np.random.default_rng(8), 8)
    assert CRITERIA == jax_select.CRITERIA
    cases = [
        (ValueError, dict(S=S, X=np.zeros((4, 8)))),
        (ValueError, dict(S=S, criterion="aic", n=10)),
        (ValueError, dict(S=S, criterion="ebic")),
        (ValueError, dict(S=S, criterion="cv", n=10)),
        (ValueError, dict(S=S, criterion="stars", n=10)),
        (ValueError, dict(S=S, grid={"auto": 5, "extra": 1}, n=10)),
        (TypeError, dict(S=S, n=10, criterion_opts={"bogus": 1})),
        (ValueError, dict(S=S, grid=[0.5, -0.1], n=10)),
    ]
    for exc, kw in cases:
        with pytest.raises(exc) as e_ref:
            jax_select.select_path(options=JAX_TIGHT, **kw)
        with pytest.raises(exc) as e_port:
            select_path(options=TIGHT, **kw)
        assert str(e_port.value) == str(e_ref.value)
