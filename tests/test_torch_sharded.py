"""The port's oversize route — the sharded solver at d = 1, the planner's
oversize class, the executor's sharded dispatch and fallback, and the
deferred from-data gather — against the reference package on its 1-device
mesh.

Tolerances, each with its reason: the sharded solve runs the reference's
float64 loops step for step, so the outer iteration counts are equal and
Theta agrees within 1e-8 (matmul, norm and CG sums add in another order;
the Newton-Schulz tolerance is tied to the primal residual, so those
last-bit differences stay below the stopping tolerance 1e-9).  Against the
dense ADMM oracle (a different algorithm) 1e-6, the reference's own test
tolerance.  Engine results: labels, route mix and counters equal, Theta
within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro.core import blocks as jax_blocks
from repro.core import glasso as jax_glasso
from repro.core.instrument import counts as jax_counts, reset as jax_reset
from repro.core.solvers import glasso_admm as jax_admm, glasso_sharded as jax_sharded
from repro.engine import EngineOptions as JaxOptions
from repro.engine.api import resolve_oversize as jax_resolve_oversize
from repro_torch import EngineOptions
from repro_torch.core import blocks as blocks_mod
from repro_torch.core import instrument
from repro_torch.core.components import component_lists
from repro_torch.core.solvers import (
    SOLVERS,
    WARM_START_SOLVERS,
    glasso_admm_stack,
    glasso_sharded,
    solver_spec,
)
from repro_torch.core.solvers.sharded import sharded_pad_size
from repro_torch.engine.api import resolve_oversize
from repro_torch.engine.planner import build_plan_incremental
from repro_torch.stream import materialize as materialize_mod
from repro_torch.stream import stream_screen
from repro_torch.stream.materialize import shard_gather

THETA_ATOL = 1e-8
ORACLE_ATOL = 1e-6
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The solvers' CPU loops run thousands of tiny batched factorizations
    and products; torch's worker threads only spin on them (several times
    the CPU time for the same wall time), starving the parallel test
    workers.  Each test runs on one thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(p, seed, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    return S, lambda_between_edges(S, q)


# ------------------------------------------------------------ the solver


@pytest.mark.parametrize("p,seed,q", [(6, 0, 0.3), (13, 1, 0.5), (22, 2, 0.6), (28, 3, 0.4)])
def test_sharded_matches_reference(p, seed, q):
    S, lam = _case(p, seed, q)
    got = glasso_sharded(S, lam, device=CPU)
    ref = jax_sharded(S, lam)
    assert (got.iters, got.retries) == (ref.iters, ref.retries)
    assert (got.b, got.padded, got.n_shards) == (ref.b, ref.padded, 1)
    assert got.device_bytes == ref.device_bytes
    np.testing.assert_allclose(got.Theta, ref.Theta, rtol=0, atol=THETA_ATOL)
    assert got.kkt_residual <= 1e-6 * max(1.0, got.s_max)
    assert got.s_max == ref.s_max


@settings(max_examples=6, deadline=None)
@given(p=st.integers(6, 28), seed=st.integers(0, 1000), q=st.floats(0.2, 0.7))
def test_sharded_matches_admm_oracle(p, seed, q):
    S, lam = _case(p, seed, q)
    res = glasso_sharded(S, lam, device=CPU)
    ref = np.asarray(jax_admm(jnp.asarray(S), lam, tol=1e-9))
    port = glasso_admm_stack(torch.as_tensor(S)[None], torch.tensor([lam], dtype=torch.float64),
                             tol=1e-9)[0].numpy()
    assert res.kkt_residual <= 1e-6 * max(1.0, res.s_max)
    for oracle in (ref, port):
        np.testing.assert_allclose(res.Theta, oracle, atol=ORACLE_ATOL)
        assert ((np.abs(res.Theta) > 1e-9) == (np.abs(oracle) > 1e-9)).all()


def test_sharded_warm_start_by_theta0():
    """Theta0 seeds Z and U through one CG inverse: the exact solution is a
    fixed point and converges in a few outer steps, as in the reference."""
    S, lam = _case(18, 4, 0.5)
    cold = glasso_sharded(S, lam, device=CPU)
    warm = glasso_sharded(S, lam, device=CPU, Theta0=cold.Theta)
    ref = jax_sharded(S, lam, Theta0=np.asarray(cold.Theta))
    assert warm.iters == ref.iters and warm.iters < cold.iters / 4
    np.testing.assert_allclose(warm.Theta, cold.Theta, atol=1e-7)
    np.testing.assert_allclose(warm.Theta, ref.Theta, rtol=0, atol=THETA_ATOL)


def test_sharded_pad_size():
    assert sharded_pad_size(5, 1) == 8
    assert sharded_pad_size(8, 1) == 8
    assert sharded_pad_size(9, 1) == 16
    assert sharded_pad_size(100, 8) == 128
    assert sharded_pad_size(64, 8) == 64
    assert sharded_pad_size(1, 8) == 64


def test_sharded_presharded_input_validates():
    arr = torch.eye(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="true block size"):
        glasso_sharded(arr, 0.1)
    with pytest.raises(ValueError, match="padded size"):
        glasso_sharded(arr, 0.1, b=3)  # 3 pads to 8, not 16
    # a padded tensor with its true size solves where it lies
    S, lam = _case(10, 5, 0.5)
    padded = shard_gather(S, np.arange(10), device=CPU)
    a = glasso_sharded(padded, lam, b=10)
    b = glasso_sharded(S, lam, device=CPU)
    assert a.iters == b.iters and np.array_equal(a.Theta, b.Theta)


def test_sharded_solver_spec():
    spec = solver_spec("sharded")
    assert spec.sharded and not spec.batched and spec.warm_startable
    assert "sharded" not in SOLVERS
    assert "sharded" not in WARM_START_SOLVERS
    with pytest.raises(ValueError, match="unknown solver"):
        solver_spec("nope")


# ------------------------------------------------- shard-direct gather


def test_shard_gather_dense_matches_pad(monkeypatch):
    S = random_covariance(np.random.default_rng(0), 30)
    comp = np.arange(3, 25)  # b = 22 pads to 24 on one device
    for chunk in (1024, 5):
        monkeypatch.setattr(materialize_mod, "GATHER_ROWS", chunk)
        arr = torch.cat(shard_gather(S, comp, device=CPU)).numpy()
        bp = sharded_pad_size(comp.size, 1)
        assert arr.shape == (bp, bp)
        np.testing.assert_array_equal(arr[: comp.size, : comp.size], S[np.ix_(comp, comp)])
        pad = np.arange(comp.size, bp)
        assert (arr[pad, pad] == 1.0).all()
        assert arr[comp.size :, : comp.size].sum() == 0.0
        assert arr[: comp.size, comp.size :].sum() == 0.0


def _factor_data(seed=0, n=64, p=48, k=30):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 1))
    X = 0.3 * rng.standard_normal((n, p))
    X[:, :k] += f * (0.8 + 0.2 * rng.random(k))
    return X


def test_materialize_deferred_oversize(monkeypatch):
    """Oversize components keep NO block; gathers recompute from X and
    equal the materialized blocks."""
    X = _factor_data()
    lam = 0.1
    instrument.reset("stream.")
    full = stream_screen(X, [lam], device=CPU)
    deferred = stream_screen(X, [lam], device=CPU, oversize=20)
    assert instrument.count("stream.deferred_components") >= 1
    np.testing.assert_array_equal(full.labels[0], deferred.labels[0])
    big = 0
    for comp in component_lists(full.labels[0]):
        if comp.size == 1:
            continue
        big += comp.size > 20
        np.testing.assert_allclose(
            deferred.S.gather_block(comp), full.S.gather_block(comp), rtol=0, atol=1e-12
        )
        np.testing.assert_allclose(
            deferred.S.gather_block_rows(comp[:3], comp),
            full.S.gather_block(comp)[:3, :], rtol=0, atol=1e-12,
        )
        monkeypatch.setattr(materialize_mod, "GATHER_ROWS", 7)
        sg = torch.cat(shard_gather(deferred.S, comp, device=CPU)).numpy()
        np.testing.assert_allclose(
            sg[: comp.size, : comp.size], full.S.gather_block(comp), rtol=0, atol=1e-12
        )
    assert big >= 1 and instrument.count("stream.deferred_gathers") >= 1


# ----------------------------------------- planner / engine integration


def test_oversize_threshold_model():
    # 8 buffers * 8 bytes * b^2 <= budget  ->  b = sqrt(budget/64)
    assert blocks_mod.SINGLE_DEVICE_BUFFERS == jax_blocks.SINGLE_DEVICE_BUFFERS
    for mb in (64.0, 0.001, 80 * 1024.0):
        assert blocks_mod.oversize_threshold(mb) == jax_blocks.oversize_threshold(mb)
    assert blocks_mod.oversize_threshold(64.0) == int(np.sqrt(64 * 2**20 / 64))
    assert blocks_mod.oversize_threshold(0.001) >= 1


def test_resolve_oversize():
    for args in ((None, None), (123, None), (123, 64.0), (None, 64.0), (None, "auto")):
        got = resolve_oversize(*args, np.float64, device=CPU)
        assert got == jax_resolve_oversize(*args, np.float64)
    assert resolve_oversize(None, "auto", np.float64, device=CPU) is None
    with pytest.raises(ValueError, match="route=True"):
        resolve_oversize(123, None, np.float64, route=False)


def test_auto_budget_reads_what_the_allocator_can_hold(monkeypatch):
    """oversize_budget_mb="auto" on a card: the free bytes CUDA reports
    plus what the caching allocator already reserves (the
    counterpart of the reference's ``bytes_limit``), not the card's total;
    the CUDA queries are stood in for here."""
    from repro_torch.core.distributed import device_memory_budget_mb

    free, total, reserved = 70 * 2**30, 80 * 2**30, 3 * 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, total))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: reserved)
    budget = device_memory_budget_mb("cuda")
    assert budget == (free + reserved) / 2**20 == 73 * 1024
    assert device_memory_budget_mb(CPU) is None
    want = blocks_mod.oversize_threshold(budget, np.float64)
    assert want == jax_blocks.oversize_threshold(budget, np.float64) == int(np.sqrt(73 * 2**30 / 64))
    assert resolve_oversize(None, "auto", np.float64, device="cuda") == want
    assert resolve_oversize(None, "auto", np.float32, device="cuda") == int(
        np.sqrt(73 * 2**30 / 32))


def test_oversize_bucket_has_no_host_blocks():
    S, lam = _case(24, 0, 0.2)
    plan, _ = build_plan_incremental(S, lam, np.zeros(24, dtype=np.int64), oversize=10)
    big = [b for b in plan.buckets if b.structure == "oversize"]
    assert big and all(b.blocks is None for b in big)
    assert plan.block_bytes() == 0


def _both(S, lam, *, X=None, **opts):
    """One options value through both packages, counters reset just before."""
    jopts = JaxOptions(**opts)
    jax_reset("")
    instrument.reset("")
    if X is None:
        ref = jax_glasso(S, lam, options=jopts)
    else:
        ref = jax_glasso(X=X, lam=lam, options=jopts)
    jc = jax_counts("")
    topts = EngineOptions.from_reference(dataclasses.asdict(jopts), device="cpu")
    if X is None:
        got = repro_torch.glasso(S, lam, options=topts)
    else:
        got = repro_torch.glasso(X=X, lam=lam, options=topts)
    return got, ref, jc


def _assert_same(got, ref, jc, prefixes):
    assert np.array_equal(got.labels, ref.labels)
    assert got.route_mix == ref.route_mix
    assert got.oversize == ref.oversize
    for prefix in prefixes:
        want = {k: v for k, v in jc.items() if k.startswith(prefix)}
        assert instrument.counts(prefix) == want, prefix
    np.testing.assert_allclose(got.Theta, ref.Theta, rtol=0, atol=THETA_ATOL)


@pytest.mark.parametrize("threshold", [12, 20])
def test_engine_oversize_route_matches_reference(threshold):
    S, lam = _case(26, 3, 0.3)
    got, ref, jc = _both(S, lam, solver="admm", oversize_threshold=threshold,
                         solver_opts={"tol": 1e-9})
    assert got.route_mix.get("oversize", 0) == 1 and got.oversize["dispatched"] == 1
    assert got.oversize["fallbacks"] == 0
    _assert_same(got, ref, jc, ("router.", "solver.oversize.", "structure.classified."))
    base = repro_torch.glasso(S, lam, options=EngineOptions(
        solver="admm", solver_opts={"tol": 1e-9}, device="cpu"))
    np.testing.assert_allclose(got.Theta, base.Theta, atol=ORACLE_ATOL)
    assert got.noniterative_fraction > 0.0


@pytest.mark.parametrize("solver", ["admm", "bcd"])
def test_engine_oversize_fallback_matches_reference(solver):
    """A KKT target no solve can reach (route_check_tol 1e-14) sends the
    oversize block down the fallback in both packages, with the same
    counts; the repaired Theta is the engine solver's."""
    S, lam = _case(20, 6, 0.35)
    got, ref, jc = _both(S, lam, solver=solver, oversize_threshold=8,
                         route_check_tol=1e-14, solver_opts={"tol": 1e-9})
    assert got.oversize["fallbacks"] == 1 == instrument.count("solver.oversize.fallbacks")
    assert instrument.count("router.fallback.oversize") == 1
    _assert_same(got, ref, jc, ("router.", "solver.oversize.", "executor.dispatches"))


def test_engine_oversize_off_without_screening_or_routing():
    S, lam = _case(16, 1, 0.3)
    got, ref, _ = _both(S, lam, solver="admm", oversize_threshold=4, route=True)
    assert got.route_mix == ref.route_mix
    unscreened = repro_torch.glasso(S, lam, screen=False, options=EngineOptions(
        solver="admm", oversize_threshold=4, device="cpu"))
    assert unscreened.oversize == {}
    with pytest.raises(ValueError, match="route=True"):
        repro_torch.Engine(options=EngineOptions(oversize_threshold=4, route=False,
                                                 device="cpu"))


def test_from_data_oversize_matches_reference():
    X = _factor_data(seed=1)
    lam = 0.1
    got, ref, jc = _both(None, lam, X=X, solver="admm", oversize_threshold=20,
                         solver_opts={"tol": 1e-9})
    assert got.route_mix.get("oversize", 0) >= 1 and got.oversize["fallbacks"] == 0
    _assert_same(got, ref, jc, ("router.", "solver.oversize.", "stream.deferred"))


# ------------------------------------------- several shards (CPU devices)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_sharded_at_d_shards_matches_one_shard(d):
    """d row shards of (bp/d, bp), never the whole block on one shard: the
    same solve as d = 1 within the solver's tolerance (the ring matmuls and
    reductions add in shard order), at d's own pad size."""
    S, lam = _case(22, 2, 0.6)
    one = glasso_sharded(S, lam, device=CPU)
    got = glasso_sharded(S, lam, mesh=[CPU] * d)
    assert (got.b, got.padded, got.n_shards) == (22, sharded_pad_size(22, d), d)
    assert got.device_bytes == 12 * (got.padded // d) * got.padded * 8
    assert got.kkt_residual <= 1e-6 * max(1.0, got.s_max)
    np.testing.assert_allclose(got.Theta, one.Theta, rtol=0, atol=1e-7)
    warm = glasso_sharded(S, lam, mesh=[CPU] * d, Theta0=got.Theta)
    assert warm.iters < got.iters / 4
    np.testing.assert_allclose(warm.Theta, got.Theta, atol=1e-7)


def test_shard_gather_at_d_shards_is_the_padded_block_by_rows(monkeypatch):
    S = random_covariance(np.random.default_rng(3), 40)
    comp = np.arange(2, 37)  # b = 35 pads to 48 on 3 shards (16 rows each)
    monkeypatch.setattr(materialize_mod, "GATHER_ROWS", 7)
    shards = shard_gather(S, comp, [CPU] * 3)
    bp = sharded_pad_size(comp.size, 3)
    assert [tuple(s.shape) for s in shards] == [(bp // 3, bp)] * 3
    want = np.eye(bp)
    want[: comp.size, : comp.size] = S[np.ix_(comp, comp)]
    np.testing.assert_array_equal(torch.cat(shards).numpy(), want)
    with pytest.raises(ValueError, match="shards"):
        glasso_sharded(shards, 0.1, b=comp.size, mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="padded size"):
        glasso_sharded(shards, 0.1, b=3)
