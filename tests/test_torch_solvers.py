"""The port's ``pg`` and ``admm`` block solvers and their kernels' plain
versions (``prox_l1``, ``shard_prox``) against the reference package.

The same numpy inputs go through ``repro`` (JAX on the CPU; its Pallas
kernels in interpret mode) and ``repro_torch`` on the CPU (the kernels'
plain PyTorch versions).  Tolerances, each with its reason:

* ``prox_l1`` equals the reference's arithmetic evaluated operation by
  operation bit for bit.  Under ``jit`` XLA's CPU backend contracts
  theta - t*grad into one fused multiply-add, so the jitted reference and
  its Pallas kernel in interpret mode round that difference once where the
  port (and its CUDA kernel, which rounds each product explicitly) rounds
  twice: they agree to 2 ulps of max|theta - t*grad|.
* ``shard_prox``: Z' and U' are bit-equal to the reference (one add, one
  soft-threshold, one subtract per entry); rp2/rd2 add the same squares in
  another order, 1e-13 relative.
* ``pg``: 1e-6 per lane.  The solver stops at tol = 1e-7 on the iterate
  change, and its line search's accept test can flip on last-bit
  differences of ``logdet`` between LAPACK builds.
* ``admm``: Theta within 1e-9 and the iteration counts equal lane by lane —
  both packages run the same float64 iteration; only eigh's and the
  residual sums' last bits differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro.core import glasso as jax_glasso
from repro.core.instrument import counts as jax_counts, reset as jax_reset
from repro.core.solvers import glasso_admm_info as jax_admm_info, glasso_pg
from repro.core.solvers.kkt import glasso_objective, kkt_residual as jax_kkt
from repro.engine import EngineOptions as JaxOptions
from repro.kernels.prox_l1 import prox_step as jax_prox_step
from repro.kernels.prox_l1.ref import prox_step_ref as jax_prox_ref
from repro.kernels.shard_prox import fused_prox_pallas, fused_prox_ref as jax_fused_ref
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.solvers import (
    SOLVERS,
    WARM_START_SOLVERS,
    glasso_admm_info,
    glasso_pg_stack,
    kkt_residual,
    solver_spec,
)
from repro_torch.kernels.build import lane_operand
from repro_torch.kernels.prox_l1 import prox_step, prox_step_ref
from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

PG_ATOL = 1e-6
ADMM_ATOL = 1e-9
SUM_RTOL = 1e-13


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


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _lanes(seeds, p, q):
    """Identity-padded (N, p, p) stack of random covariances of sizes
    p - 2 .. p and one lambda per lane."""
    blocks, lams = [], []
    for k, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        b = p - (k % 3)
        S = random_covariance(rng, b)
        pad = np.eye(p)
        pad[:b, :b] = S
        blocks.append(pad)
        lams.append(lambda_between_edges(S, q))
    return np.stack(blocks), np.asarray(lams)


# ---------------------------------------------------------------- prox_l1


@pytest.mark.parametrize("B,b", [(1, 8), (3, 7), (2, 33)])
def test_prox_plain_equals_reference(B, b):
    rng = np.random.default_rng(B * 100 + b)
    theta = rng.standard_normal((B, b, b))
    grad = rng.standard_normal((B, b, b))
    t, lam = 0.37, 0.61
    got = prox_step_ref(_t(theta), _t(grad), t, lam).numpy()
    with jax.disable_jit():  # the reference's arithmetic, operation by operation
        exact = np.asarray(jax_prox_ref(jnp.asarray(theta), jnp.asarray(grad), t, lam))
    assert np.array_equal(got, exact)
    # the jitted reference and its Pallas kernel (interpret mode) contract
    # theta - t*grad into one FMA: 2 ulps of the largest |theta - t*grad|
    ulp2 = 2 * np.finfo(np.float64).eps * float(np.abs(theta - t * grad).max())
    jitted = np.asarray(jax_prox_ref(jnp.asarray(theta), jnp.asarray(grad), t, lam))
    pallas = np.asarray(jax_prox_step(jnp.asarray(theta), jnp.asarray(grad), t, lam, block=8))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=ulp2)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ulp2)
    # the wrapper runs the plain version for a CPU tensor, single blocks too
    assert np.array_equal(prox_step(_t(theta), _t(grad), t, lam).numpy(), got)
    assert np.array_equal(prox_step(_t(theta[0]), _t(grad[0]), t, lam).numpy(), got[0])


def test_prox_per_lane_equals_separate_calls():
    rng = np.random.default_rng(3)
    B, b = 5, 9
    theta, grad = _t(rng.standard_normal((B, b, b))), _t(rng.standard_normal((B, b, b)))
    t = _t(rng.uniform(0.05, 1.5, B))
    lam = _t(rng.uniform(0.0, 1.0, B))
    out = prox_step(theta, grad, t, lam)
    for k in range(B):
        one = prox_step(theta[k], grad[k], float(t[k]), float(lam[k]))
        assert torch.equal(out[k], one)


def test_prox_ties_are_exact_zeros():
    """|theta - t*grad| == t*lam thresholds to exactly 0, the plain version
    and the reference alike."""
    t, lam = 0.5, 0.75
    theta = np.array([[[0.375, -0.375, 0.5], [0.375, 1.0, -0.375], [0.0, 0.25, -1.0]]])
    grad = np.zeros_like(theta)
    got = prox_step(_t(theta), _t(grad), t, lam).numpy()
    tie = np.abs(theta) == t * lam
    assert tie.sum() == 4 and (got[tie] == 0.0).all()
    with jax.disable_jit():
        ref = np.asarray(jax_prox_ref(jnp.asarray(theta), jnp.asarray(grad), t, lam))
    assert np.array_equal(got, ref)


# ------------------------------------------------------------- shard_prox


@pytest.mark.parametrize("rl,b", [(8, 8), (16, 24), (32, 128), (8, 136)])
def test_shard_prox_plain_equals_reference_and_pallas(rl, b):
    rng = np.random.default_rng(rl + b)
    x, u, z = (rng.standard_normal((rl, b)) for _ in range(3))
    t = 0.3
    zt, ut, rp2, rd2 = fused_prox_ref(_t(x), _t(u), _t(z), t)
    zr, ur, rp2_r, rd2_r = jax_fused_ref(jnp.asarray(x), jnp.asarray(u), jnp.asarray(z), t)
    assert np.array_equal(zt.numpy(), np.asarray(zr))
    assert np.array_equal(ut.numpy(), np.asarray(ur))
    np.testing.assert_allclose(float(rp2), float(rp2_r), rtol=SUM_RTOL)
    np.testing.assert_allclose(float(rd2), float(rd2_r), rtol=SUM_RTOL)
    zp, up, acc = fused_prox_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(z), jnp.asarray(t), interpret=True
    )
    assert np.array_equal(zt.numpy(), np.asarray(zp))
    assert np.array_equal(ut.numpy(), np.asarray(up))
    np.testing.assert_allclose([float(rp2), float(rd2)], np.asarray(acc)[0], rtol=SUM_RTOL)


def test_shard_prox_row_tiled_and_stacked():
    rng = np.random.default_rng(1)
    x, u, z = (rng.standard_normal((32, 16)) for _ in range(3))
    _, _, rp2, rd2 = fused_prox_residual(_t(x), _t(u), _t(z), 0.2)
    _, _, acc = fused_prox_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(z), jnp.asarray(0.2),
        row_tile=8, interpret=True,
    )  # 4 grid steps accumulate into one (1, 2) block
    np.testing.assert_allclose([float(rp2), float(rd2)], np.asarray(acc)[0], rtol=SUM_RTOL)
    # the (N, rl, b) stack with per-lane t equals its lanes one by one
    N = 4
    xs, us, zs = (_t(rng.standard_normal((N, 12, 12))) for _ in range(3))
    ts = _t(rng.uniform(0.05, 1.0, N))
    zn, un, rp, rd = fused_prox_residual(xs, us, zs, ts)
    assert rp.shape == rd.shape == (N,)
    for k in range(N):
        zk, uk, rpk, rdk = fused_prox_residual(xs[k], us[k], zs[k], float(ts[k]))
        assert torch.equal(zn[k], zk) and torch.equal(un[k], uk)
        assert float(rp[k]) == float(rpk) and float(rd[k]) == float(rdk)


@pytest.mark.parametrize("form", ["0-d tensor", "python scalar", "per-lane tensor"])
def test_shard_prox_threshold_forms_match_reference(form):
    """The wrapper's CPU path takes t as a 0-d tensor (the sharded solver's
    lam/rho), a Python scalar, or one value a lane (the dense admm's):
    every lane equals the reference's ``fused_prox_ref`` at that lane's t."""
    rng = np.random.default_rng(11)
    N, rl, b = 3, 20, 24
    x, u, z = (rng.standard_normal((N, rl, b)) for _ in range(3))
    ts = rng.uniform(0.05, 1.0, N) if form == "per-lane tensor" else np.full(N, 0.45)
    t = {"0-d tensor": torch.tensor(0.45, dtype=torch.float64),
         "python scalar": 0.45, "per-lane tensor": _t(ts)}[form]
    zn, un, rp, rd = fused_prox_residual(_t(x), _t(u), _t(z), t)
    assert rp.shape == rd.shape == (N,)
    for k in range(N):
        zr, ur, rp_r, rd_r = jax_fused_ref(
            jnp.asarray(x[k]), jnp.asarray(u[k]), jnp.asarray(z[k]), float(ts[k]))
        assert np.array_equal(zn[k].numpy(), np.asarray(zr))
        assert np.array_equal(un[k].numpy(), np.asarray(ur))
        np.testing.assert_allclose([float(rp[k]), float(rd[k])], [float(rp_r), float(rd_r)],
                                   rtol=SUM_RTOL)
    if form != "per-lane tensor":  # one shard with a scalar t
        z1, u1, rp1, rd1 = fused_prox_residual(_t(x[0]), _t(u[0]), _t(z[0]), t)
        assert rp1.shape == () and torch.equal(z1, zn[0]) and torch.equal(u1, un[0])


# The prox wrappers pass t and lam to the kernel as (pointer, lane stride,
# value): by value for a Python scalar or a CPU 0-d tensor, by pointer for
# a tensor on the stack's device (stride 0 for a 0-d one, its own for an
# (N,) one), with nothing filled, expanded or copied.
@pytest.mark.parametrize("form", ["python scalar", "cpu 0-d float32", "(N,) tensor",
                                  "strided view", "wrong shape", "wrong dtype"])
def test_lane_operand_forms(form):
    like = torch.zeros((4, 3, 3), dtype=torch.float64)
    lanes = torch.arange(8, dtype=torch.float64)
    if form == "python scalar":
        assert lane_operand("prox_l1", "t", 0.3, 4, like) == (None, 0, 0.3)
    elif form == "cpu 0-d float32":
        x = torch.tensor(0.3, dtype=torch.float32)
        assert lane_operand("prox_l1", "lam", x, 4, like) == (None, 0, float(x))
    elif form in ("(N,) tensor", "strided view"):
        x = lanes[:4] if form == "(N,) tensor" else lanes[::2]
        got, stride, value = lane_operand("prox_l1", "t", x, 4, like)
        assert got is x and got.data_ptr() == lanes.data_ptr() and value == 0.0
        assert stride == (1 if form == "(N,) tensor" else 2)
    else:
        x = lanes[:3] if form == "wrong shape" else lanes[:4].to(torch.float32)
        with pytest.raises(ValueError, match="prox_l1: lam must be a scalar or"):
            lane_operand("prox_l1", "lam", x, 4, like)


# --------------------------------------------------------------------- pg


def test_pg_bucket_matches_vmapped_reference():
    blocks, lams = _lanes([1, 2, 3, 4], 9, 0.5)
    got = glasso_pg_stack(_t(blocks), _t(lams)).numpy()
    ref = np.asarray(jax.vmap(glasso_pg)(jnp.asarray(blocks), jnp.asarray(lams)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=PG_ATOL)
    for k in range(len(lams)):
        bound = 2e-4 * max(1.0, float(np.abs(blocks[k]).max()))
        assert float(kkt_residual(_t(blocks[k]), _t(got[k]), lams[k], zero_tol=1e-8)) < bound
        assert float(jax_kkt(jnp.asarray(blocks[k]), jnp.asarray(ref[k]), lams[k],
                             zero_tol=1e-8)) < bound


def test_pg_lane_equals_block_alone():
    """A lane's line search and stopping are its own: the bucket's lane
    equals the same block solved as a bucket of one (the batched Cholesky
    factors each matrix on its own; 1e-12 covers the batched reductions)."""
    blocks, lams = _lanes([5, 6, 7], 8, 0.7)
    bucket = glasso_pg_stack(_t(blocks), _t(lams), max_iter=200)
    for k in range(len(lams)):
        alone = glasso_pg_stack(_t(blocks[k : k + 1]), _t(lams[k : k + 1]), max_iter=200)
        np.testing.assert_allclose(bucket[k].numpy(), alone[0].numpy(), rtol=0, atol=1e-12)


def test_pg_theta0_warm_start():
    blocks, lams = _lanes([8], 7, 0.5)
    cold = glasso_pg_stack(_t(blocks), _t(lams), tol=1e-9)
    warm = glasso_pg_stack(_t(blocks), _t(lams), tol=1e-9, Theta0=cold)
    ref = np.asarray(glasso_pg(jnp.asarray(blocks[0]), lams[0], tol=1e-9,
                               Theta0=jnp.asarray(cold[0].numpy())))
    np.testing.assert_allclose(warm.numpy()[0], ref, rtol=0, atol=PG_ATOL)
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), rtol=0, atol=1e-7)


# ------------------------------------------------------------------- admm


@pytest.mark.parametrize("warm", [None, "W0", "W0+Theta0"])
def test_admm_matches_reference_lane_by_lane(warm):
    blocks, lams = _lanes([11, 12, 13, 14], 10, 0.5)
    N = len(lams)
    kw_t, kw_j = [{} for _ in range(N)], [{} for _ in range(N)]
    if warm is not None:
        # warm pairs from the solution at a 10 % larger lambda, as a path
        # step or a repair hands them over
        hi, _ = glasso_admm_info(_t(blocks), _t(1.1 * lams), tol=1e-9)
        W0 = torch.linalg.inv(hi)
        for k in range(N):
            kw_j[k]["W0"] = jnp.asarray(W0[k].numpy())
            if warm == "W0+Theta0":
                kw_j[k]["Theta0"] = jnp.asarray(hi[k].numpy())
        kw_t = {"W0": W0, "Theta0": hi if warm == "W0+Theta0" else None}
    else:
        kw_t = {}
    got, it = glasso_admm_info(_t(blocks), _t(lams), tol=1e-9, **kw_t)
    for k in range(N):
        ref, rit = jax_admm_info(jnp.asarray(blocks[k]), lams[k], tol=1e-9, **kw_j[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref), rtol=0, atol=ADMM_ATOL)
        assert int(it[k]) == int(rit), (k, int(it[k]), int(rit))


def test_admm_warm_start_cuts_iterations():
    """Port of the reference's warm-start test: an exact W0 is a fixed point,
    a nearby one cuts iterations, a degenerate one starts cold."""
    assert "admm" in WARM_START_SOLVERS and "pg" not in WARM_START_SOLVERS
    rng = np.random.default_rng(11)
    S = _t(random_covariance(rng, 14))[None]
    lam = _t([lambda_between_edges(S[0].numpy(), 0.5)])
    Theta_cold, it_cold = glasso_admm_info(S, lam, tol=1e-9)
    W0 = torch.linalg.inv(Theta_cold)
    Theta_warm, it_warm = glasso_admm_info(S, lam, tol=1e-9, W0=W0)
    assert int(it_warm) < int(it_cold) / 4, (int(it_warm), int(it_cold))
    np.testing.assert_allclose(Theta_warm.numpy(), Theta_cold.numpy(), atol=1e-7)
    lam_hi = _t([lambda_between_edges(S[0].numpy(), 0.6)])
    Theta_hi, _ = glasso_admm_info(S, lam_hi, tol=1e-9)
    _, it_near = glasso_admm_info(S, lam, tol=1e-9, W0=torch.linalg.inv(Theta_hi))
    assert int(it_near) < int(it_cold)
    Theta_bad, it_bad = glasso_admm_info(S, lam, tol=1e-9, W0=torch.zeros_like(S))
    assert int(it_bad) == int(it_cold)
    np.testing.assert_allclose(Theta_bad.numpy(), Theta_cold.numpy(), atol=1e-12)
    Theta_t0, it_t0 = glasso_admm_info(S, lam, tol=1e-9, W0=W0, Theta0=Theta_cold)
    assert int(it_t0) <= int(it_warm)
    np.testing.assert_allclose(Theta_t0.numpy(), Theta_cold.numpy(), atol=1e-7)


# ------------------------------------------------------- solvers agree


def _solve(name, S, lam, **opts):
    return SOLVERS[name](_t(S)[None], _t([lam]), **opts)[0].numpy()


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@settings(max_examples=10, deadline=None)
@given(p=st.integers(2, 12), seed=st.integers(0, 1000), q=st.floats(0.2, 0.9))
def test_kkt_optimality(solver, p, seed, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lam = lambda_between_edges(S, q)
    Theta = _solve(solver, S, lam, tol=1e-9)
    res = float(kkt_residual(_t(S), _t(Theta), lam, zero_tol=1e-8))
    assert res < 2e-4 * max(float(np.abs(S).max()), 1.0), f"{solver} kkt residual {res}"


@settings(max_examples=8, deadline=None)
@given(p=st.integers(2, 10), seed=st.integers(0, 1000))
def test_solvers_agree(p, seed):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lam = lambda_between_edges(S, 0.5)
    assert sorted(SOLVERS) == ["admm", "bcd", "fused_bcd", "pg"]
    thetas = {name: _solve(name, S, lam, tol=1e-9) for name in SOLVERS}
    objs = {
        name: float(glasso_objective(jnp.asarray(S), jnp.asarray(T), lam))
        for name, T in thetas.items()
    }
    best = min(objs.values())
    for name, obj in objs.items():
        assert obj - best < 1e-4 * max(abs(best), 1.0), (name, objs)
    np.testing.assert_allclose(thetas["bcd"], thetas["admm"], atol=5e-4)
    np.testing.assert_allclose(thetas["pg"], thetas["admm"], atol=5e-4)


def test_solver_specs():
    pg, admm, sharded = solver_spec("pg"), solver_spec("admm"), solver_spec("sharded")
    assert pg.batched and not pg.warm_startable
    assert admm.batched and admm.warm_startable and admm.meta["theta_warm"]
    assert sharded.sharded and not sharded.batched and sharded.meta["warm_kwarg"] == "Theta0"
    assert "sharded" not in SOLVERS and "sharded" not in WARM_START_SOLVERS


# ----------------------------------------------------------------- engine


def _general_covariance(seed):
    """Planted blocks plus two random dense blocks, so the plan holds pairs,
    trees and general buckets (the pg/admm lanes)."""
    from repro.covariance import structured_synthetic

    S = structured_synthetic(6, 8, seed=seed)
    rng = np.random.default_rng(seed)
    p = S.shape[0]
    out = np.zeros((p + 20, p + 20))
    out[:p, :p] = S
    for lo in (p, p + 10):
        out[lo : lo + 10, lo : lo + 10] = 2.0 * random_covariance(rng, 10)
    return out


@pytest.mark.parametrize("solver", ["pg", "admm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_solver_matches_reference(solver, seed):
    S = _general_covariance(seed)
    lam = 0.6
    jopts = JaxOptions(solver=solver)
    jax_reset("")
    instrument.reset("")
    ref = jax_glasso(S, lam, options=jopts)
    got = repro_torch.glasso(
        S, lam, options=EngineOptions.from_reference(dataclasses.asdict(jopts), device="cpu")
    )
    assert np.array_equal(got.labels, ref.labels)
    assert got.route_mix == ref.route_mix and got.route_mix.get("general", 0) >= 2
    assert instrument.counts("router.") == jax_counts("router.")
    atol = PG_ATOL if solver == "pg" else ADMM_ATOL
    np.testing.assert_allclose(got.Theta, ref.Theta, rtol=0, atol=atol)
    assert got.oversize == {} == ref.oversize
