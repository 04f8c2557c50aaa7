"""The port's out-of-core screen and ``glasso(X=...)`` against the
reference package.

``repro_torch.stream.stream_screen`` (plain covgram_screen on the CPU) must
reproduce ``repro.stream.stream_screen``: the same partition per lambda, the
same compacted edges, the same tile schedule and the same ``stream.*``
counters.  Integer X with a power-of-two n makes every covariance entry an
exact dyadic rational in any summation order, so edges and materialized
blocks are compared bit for bit and lam can be an existing |S_ij| (a true
tie, picked from the values themselves — never a median, which need not be
one).  ``glasso(X=...)`` must match the reference's ``glasso(X=...,
from_data=True)`` on labels and route mix, Theta within ATOL = 1e-9 (as in
tests/test_torch_glasso.py), and both must pass the reference's
``kkt_residual``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from conftest import lambda_between_edges
from repro.core import glasso as jax_glasso
from repro.core.instrument import counts as jax_counts, reset as jax_reset
from repro.core.solvers.kkt import kkt_residual
from repro.covariance import sample_correlation as jax_correlation
from repro.covariance import sample_covariance as jax_covariance
from repro.engine import EngineOptions as JaxOptions
from repro.select.grid import lambda_max as jax_lambda_max
from repro.select.grid import normalize_lambda_grid as jax_normalize
from repro.stream import StreamConfig as JaxStreamConfig
from repro.stream import stream_screen as jax_stream_screen
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.components import component_lists
from repro_torch.core.screening import (
    count_edges,
    screen_stats_from_labels,
    thresholded_components,
)
from repro_torch.covariance import sample_correlation, sample_covariance
from repro_torch.select.grid import lambda_max, normalize_lambda_grid
from repro_torch.stream import StreamConfig, as_config, shard_gather, stream_screen

ATOL = 1e-9
CFG = {"tile": 32, "chunk": 16, "pair_batch": 3}  # 32 does not divide the ps below
CPU = EngineOptions(device="cpu", output="dense")


def _data(rng, n, p):
    return rng.standard_normal((n, p)) * (0.1 + rng.random(p))


def _integer_data(rng, n, p):
    assert n & (n - 1) == 0
    return rng.integers(-4, 5, size=(n, p)).astype(np.float64)


def _dense_S(X):
    Xc = X - X.mean(axis=0)
    return Xc.T @ Xc / X.shape[0]


def _grouped(rng, n, p, groups, size=5, load=0.8):
    """Planted groups of ``size`` columns (small components: pairs, trees,
    chordal and general blocks) over weak independent columns."""
    X = _data(rng, n, p) * 0.3
    f = rng.standard_normal((n, groups))
    for g in range(groups):
        cols = slice(g * size, g * size + size)
        X[:, cols] = load * f[:, [g]] + 0.6 * rng.standard_normal((n, size))
    return X


def _both(X, lams, config=CFG):
    jax_reset("stream.")
    instrument.reset("stream.")
    want = jax_stream_screen(X, lams, config=config)
    got = stream_screen(X, lams, config=config, device="cpu")
    return got, want


@pytest.mark.parametrize("seed,n,p", [(0, 16, 21), (1, 40, 50), (2, 32, 70)])
def test_stream_screen_matches_reference(seed, n, p):
    rng = np.random.default_rng(seed)
    X = _data(rng, n, p)
    S = _dense_S(X)
    lams = [lambda_between_edges(S, 0.9), lambda_between_edges(S, 0.6)]
    got, want = _both(X, lams)
    assert got.lambdas == want.lambdas
    for a, b in zip(got.labels, want.labels):
        assert np.array_equal(a, b)
    assert np.array_equal(got.edges[0], want.edges[0])
    assert np.array_equal(got.edges[1], want.edges[1])
    np.testing.assert_allclose(got.edges[2], want.edges[2], rtol=0, atol=1e-12)
    assert (got.tiles_total, got.tiles_skipped) == (want.tiles_total, want.tiles_skipped)
    assert instrument.counts("stream.") == jax_counts("stream.")
    for a, b in zip(got.stats, want.stats):
        assert (a.n_components, a.max_comp, a.n_isolated, a.n_edges) == (
            b.n_components, b.max_comp, b.n_isolated, b.n_edges)
        assert (a.tiles_total, a.tiles_skipped, a.edges_emitted, a.bytes_peak) == (
            b.tiles_total, b.tiles_skipped, b.edges_emitted, b.bytes_peak)


def test_stream_screen_skips_tiles_like_the_reference():
    """Heteroscedastic columns: the Cauchy-Schwarz bound prunes pairs, and
    both packages prune the same ones."""
    rng = np.random.default_rng(3)
    p = 96
    X = rng.standard_normal((32, p)) * np.where(np.arange(p) < 32, 1.0, 0.02)
    got, want = _both(X, [0.3, 0.2])
    assert got.tiles_skipped == want.tiles_skipped > 0
    assert instrument.counts("stream.") == jax_counts("stream.")
    for a, b in zip(got.labels, want.labels):
        assert np.array_equal(a, b)


def test_tile_records_match_reference():
    """keep_tile_stats=True: one record per scheduled tile pair, skipped or
    computed, with the same edges and bounds as the reference's records."""
    rng = np.random.default_rng(8)
    p = 96
    X = rng.standard_normal((32, p)) * np.where(np.arange(p) < 40, 1.0, 0.02)
    lams = [0.3, 0.2]
    want = jax_stream_screen(X, lams, config=CFG, keep_tile_stats=True)
    got = stream_screen(X, lams, config=CFG, keep_tile_stats=True, device="cpu")
    assert set(got.tiles) == set(want.tiles)
    assert len(got.tiles) == got.tiles_total
    assert any(r.skipped for r in got.tiles.values())
    assert any(r.n_edges for r in got.tiles.values())
    for key, b in want.tiles.items():
        a = got.tiles[key]
        assert (a.skipped, a.n_edges) == (b.skipped, b.n_edges)
        if a.skipped:
            assert a.gi is None and b.gi is None
            continue
        assert np.array_equal(a.gi, b.gi) and np.array_equal(a.gj, b.gj)
        np.testing.assert_allclose(a.w, b.w, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            [a.min_above, a.max_below], [b.min_above, b.max_below], rtol=0, atol=1e-12)
        assert a.max_below <= 0.2 < a.min_above
    assert stream_screen(X, lams, config=CFG, device="cpu").tiles == {}


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_lower_precision_data_is_screened_in_float64(dtype):
    """float32 or integer X is promoted to float64 before the tiles are
    computed (the CUDA kernel is float64): the screen equals that of the
    same values held in float64, bit for bit."""
    rng = np.random.default_rng(13)
    X = _integer_data(rng, 32, 70).astype(dtype)
    if dtype == np.float32:
        X = X * np.float32(0.37)
    X64 = X.astype(np.float64)
    S = _dense_S(X64)
    lams = [lambda_between_edges(S, 0.95), lambda_between_edges(S, 0.8)]
    got = stream_screen(X, lams, config=CFG, device="cpu")
    want = stream_screen(X64, lams, config=CFG, device="cpu")
    for a, b in zip(got.labels, want.labels):
        assert np.array_equal(a, b)
    for k in range(3):
        assert np.array_equal(got.edges[k], want.edges[k])
    assert got.edges[2].dtype == np.float64
    comps = [c for c in component_lists(got.labels[-1]) if len(c) > 1]
    assert comps
    for comp in comps:
        assert np.array_equal(got.S.gather_block(comp), want.S.gather_block(comp))


@pytest.mark.parametrize("seed", [11, 1999, 4242])
def test_streamed_ties_are_not_edges(seed):
    """lam is an existing |S_ij| taken from vals[vals > 0]: a true tie."""
    rng = np.random.default_rng(seed)
    X = _integer_data(rng, 16, 40)
    S = _dense_S(X)
    vals = np.abs(S[np.triu_indices(40, 1)])
    pos = np.sort(vals[vals > 0])
    lam = float(pos[pos.size // 2])
    assert (vals == lam).any()
    got, want = _both(X, [lam])
    labels, stats = thresholded_components(S, lam)
    assert np.array_equal(got.labels[0], labels)
    assert got.stats[0].n_edges == stats.n_edges == int((vals > lam).sum())
    for k in range(3):
        assert np.array_equal(got.edges[k], want.edges[k])


def test_materialized_blocks_equal_dense_sample_covariance_bitwise():
    rng = np.random.default_rng(5)
    X = _integer_data(rng, 32, 70)
    S = sample_covariance(X, device="cpu").numpy()
    vals = np.abs(S[np.triu_indices(70, 1)])
    lam = float(np.sort(vals[vals > 0])[int(0.97 * vals.size)])
    sc = stream_screen(X, [lam], config=CFG, device="cpu")
    assert np.array_equal(sc.S.diag_at(np.arange(70)), np.diag(S))
    comps = [c for c in component_lists(sc.labels[0]) if len(c) > 1]
    assert comps
    for comp in comps:
        assert np.array_equal(sc.S.gather_block(comp), S[np.ix_(comp, comp)])
        rows = comp[: len(comp) // 2 + 1]
        assert np.array_equal(sc.S.gather_block_rows(rows, comp), S[np.ix_(rows, comp)])
    # and the reference's materialized blocks are the same numbers
    want = jax_stream_screen(X, [lam], config=CFG)
    for comp in comps:
        assert np.array_equal(sc.S.gather_block(comp), want.S.gather_block(comp))


def test_cross_component_gather_raises_and_dense_only_helpers_refuse():
    rng = np.random.default_rng(6)
    X = _grouped(rng, 32, 40, groups=3)
    sc = stream_screen(X, [0.35], config=CFG, device="cpu")
    comps = component_lists(sc.labels[0])
    assert len(comps) >= 2
    with pytest.raises(ValueError, match="across components"):
        sc.S.gather_block(np.array([comps[0][0], comps[1][0]]))
    with pytest.raises(TypeError, match="dense S"):
        count_edges(sc.S, 0.35)
    st = screen_stats_from_labels(sc.S, 0.35, sc.labels[0], seconds=0.0, n_edges=7)
    assert st.n_edges == 7
    with pytest.raises(ValueError, match="cannot be re-screened"):
        repro_torch.Engine(options=CPU).run(sc.S, 0.35)
    with pytest.raises(ValueError, match="across components"):
        shard_gather(sc.S, np.array([comps[0][0], comps[1][0]]), device="cpu")


def _kkt(S, Theta, lam):
    return float(kkt_residual(jnp.asarray(S), jnp.asarray(Theta), lam, zero_tol=1e-12))


@pytest.mark.parametrize("seed,lam,route", [(0, 0.35, True), (1, 0.4, True), (2, 0.3, False)])
def test_glasso_from_data_matches_reference(seed, lam, route):
    rng = np.random.default_rng(seed)
    X = _grouped(rng, 64, 60, groups=6, size=6, load=0.6)
    stream = {"tile": 16, "chunk": 8, "pair_batch": 4}
    jopts = JaxOptions(route=route, output="dense", solver_opts={"tol": 1e-9})
    want = jax_glasso(X=X, lam=lam, from_data=True, stream=stream, options=jopts)
    got = repro_torch.glasso(
        X=X, lam=lam, from_data=True, stream=stream,
        options=EngineOptions.from_reference(dataclasses.asdict(jopts), device="cpu"),
    )
    assert np.array_equal(got.labels, want.labels)
    assert got.route_mix == want.route_mix
    if seed == 0:  # every rung: closed form, chordal and the BCD tail
        assert {"tree", "chordal", "general"} <= set(got.route_mix)
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=ATOL)
    S = _dense_S(X)
    bound = 1e-5 * max(1.0, float(np.abs(S).max()))
    assert _kkt(S, got.Theta, lam) <= bound and _kkt(S, want.Theta, lam) <= bound
    assert got.screen.tiles_total == want.screen.tiles_total
    assert got.screen.edges_emitted == want.screen.edges_emitted
    # and the dense path on the port's own estimator gives the same answer
    dense = repro_torch.glasso(sample_covariance(X, device="cpu").numpy(), lam,
                               options=CPU.replace(route=route, solver_opts={"tol": 1e-9}))
    assert np.array_equal(dense.labels, got.labels)
    np.testing.assert_allclose(dense.Theta, got.Theta, rtol=0, atol=ATOL)


def test_glasso_argument_checks_match_reference():
    X = np.random.default_rng(0).standard_normal((8, 5))
    S = _dense_S(X)
    cases = [
        dict(S=S, X=X, lam=0.1),
        dict(from_data=True, lam=0.1),
        dict(X=X),
        dict(S=S),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as e_ref:
            jax_glasso(**kw)
        with pytest.raises(ValueError) as e_port:
            repro_torch.glasso(**kw, options=CPU)
        assert str(e_port.value) == str(e_ref.value)
    # S with from_data=True is the data matrix, as in the reference
    r = repro_torch.glasso(X, 0.1, from_data=True, options=CPU, stream={"tile": 4})
    assert r.Theta.shape == (5, 5)
    # the path's argument checks are the reference's too, word for word
    from repro.core import glasso_path as jax_glasso_path

    for kw in (dict(S=S, X=X, lambdas=[0.1]), dict(from_data=True, lambdas=[0.1]),
               dict(X=X), dict(S=S)):
        with pytest.raises(ValueError) as e_ref:
            jax_glasso_path(**kw)
        with pytest.raises(ValueError) as e_port:
            repro_torch.glasso_path(**kw, options=CPU)
        assert str(e_port.value) == str(e_ref.value)
    got = repro_torch.glasso_path(X=X, lambdas=[0.1], from_data=True, options=CPU,
                                  stream={"tile": 4})
    want = jax_glasso_path(X=X, lambdas=[0.1], from_data=True, stream={"tile": 4})
    assert np.array_equal(got[0].labels, want[0].labels)
    np.testing.assert_allclose(got[0].Theta, np.asarray(want[0].Theta), rtol=0, atol=1e-7)


def test_stream_options_carry_across():
    ref = JaxOptions(cc_backend="pallas", stream=JaxStreamConfig(tile=64, chunk=32))
    port = EngineOptions.from_reference(dataclasses.asdict(ref), device="cpu")
    assert port.cc_backend == "pallas"
    assert as_config(port.stream) == StreamConfig(tile=64, chunk=32)
    assert as_config(JaxStreamConfig(tile=8, backend="ref")) == StreamConfig(tile=8, backend="ref")
    assert as_config(None) == StreamConfig()
    with pytest.raises(TypeError):
        as_config(3)
    with pytest.raises(ValueError, match="backend"):
        StreamConfig(backend="tpu")
    # the port's kernel is float64: a memory budget buys tile^2 * 8 bytes a pair
    cfg = StreamConfig(tile=512, memory_budget_mb=8)
    assert cfg.resolved_pair_batch(8) == 4
    X = np.random.default_rng(1).standard_normal((8, 6))
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        stream_screen(X, [0.1], config={"backend": "pallas"}, device="cpu")
    a = stream_screen(X, [0.1], config={"tile": 4, "backend": "ref"}, device="cpu")
    b = stream_screen(X, [0.1], config={"tile": 4}, device="cpu")
    assert np.array_equal(a.labels[0], b.labels[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_estimators_match_reference(dtype):
    rng = np.random.default_rng(9)
    X = (rng.standard_normal((30, 12)) * (0.5 + rng.random(12))).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for port_fn, ref_fn in ((sample_covariance, jax_covariance),
                            (sample_correlation, jax_correlation)):
        for ddof in (0, 1):
            got = port_fn(X, ddof=ddof, device="cpu")
            want = np.asarray(ref_fn(jnp.asarray(X), ddof=ddof))
            assert got.numpy().dtype == want.dtype
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
            assert torch.equal(got, got.T)
    Xi = _integer_data(rng, 16, 9)
    assert np.array_equal(sample_covariance(Xi, device="cpu").numpy(), _dense_S(Xi))


def test_estimators_accumulate_low_precision_in_float32():
    rng = np.random.default_rng(10)
    X = torch.as_tensor(rng.standard_normal((50, 7))).to(torch.bfloat16)
    got = sample_covariance(X, chunk=16)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jax_covariance(jnp.asarray(X.float().numpy()).astype(jnp.bfloat16), chunk=16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_lambda_grid_helpers_match_reference():
    rng = np.random.default_rng(12)
    S = _dense_S(_data(rng, 20, 9))
    assert lambda_max(S) == jax_lambda_max(S)
    assert lambda_max(np.eye(1)) == 0.0
    assert normalize_lambda_grid([0.1, 0.3, 0.1, 0.2]) == jax_normalize([0.1, 0.3, 0.1, 0.2])
    for bad in ([], [0.1, -1.0], [np.inf], [0.0]):
        with pytest.raises(ValueError) as e_ref:
            jax_normalize(bad)
        with pytest.raises(ValueError) as e_port:
            normalize_lambda_grid(bad)
        assert str(e_port.value) == str(e_ref.value)
