"""The port's bucket_glasso module against the reference package.

The plain PyTorch version (``repro_torch.kernels.bucket_glasso.ref``) is
held against the JAX reference ``fused_bcd_ref_stack`` (and the Pallas
kernel in interpret mode) on the same numpy inputs, cold and warm lanes:
sweep counts must be identical lane by lane, Theta within 1e-9 absolute.
The arithmetic is the same float64 sequence except the order of dot
products and sums, whose rounding (~1e-16 relative) is carried through the
sweeps; the observed differences are ~1e-16, and 1e-9 stays far inside the
solver's own convergence tolerance (tol*scale = 1e-6*scale).  The CUDA
kernel is held against the plain version on the card in
tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import lambda_between_edges, random_covariance
from repro.core.solvers.bcd import glasso_bcd
from repro.core.solvers.kkt import kkt_residual as jax_kkt_residual
from repro.kernels.bucket_glasso.bucket_glasso import fused_bcd_pallas
from repro.kernels.bucket_glasso.ref import fused_bcd_ref_stack as jax_ref_stack
from repro_torch.core.blocks import pad_block
from repro_torch.core.solvers.bcd import convergence_scale, glasso_bcd_stack
from repro_torch.kernels.bucket_glasso import (
    fused_bcd_ref_stack,
    fused_bcd_single,
    fused_bcd_stack,
)

ATOL = 1e-9


def _lanes(rng, N, b, *, pad=0, q=0.6):
    """N dense sample covariances (b - pad live coordinates, identity-padded
    to b), each with its own lambda at quantile q of its |S_ij|."""
    m = b - pad
    S = [random_covariance(rng, m) for _ in range(N)]
    lams = np.array([lambda_between_edges(s, q) for s in S])
    return np.stack([pad_block(s, b) for s in S]), lams


def _scales(S):
    return convergence_scale(torch.as_tensor(S)).numpy()


def _cold_pair(S, lams):
    N, b, _ = S.shape
    W0 = S + lams[:, None, None] * np.eye(b)[None]
    T0 = np.broadcast_to(np.eye(b), (N, b, b)).copy()
    return W0, T0


def _warm_pair(S, lams):
    """Warm start from the solution at a 20% larger lambda (a path step)."""
    W0, T0 = _cold_pair(S, 1.2 * lams)
    T, _ = fused_bcd_ref_stack(*(torch.as_tensor(x) for x in (S, 1.2 * lams, _scales(S), W0, T0)))
    T = T.numpy()
    return np.linalg.inv(T), T


def _both(S, lams, W0, T0):
    scales = _scales(S)
    t_jax, sw_jax = jax_ref_stack(*(jnp.asarray(x) for x in (S, lams, scales, W0, T0)))
    t_pt, sw_pt = fused_bcd_ref_stack(*(torch.as_tensor(x) for x in (S, lams, scales, W0, T0)))
    return np.asarray(t_jax), np.asarray(sw_jax), t_pt.numpy(), sw_pt.numpy()


@pytest.mark.parametrize("b,pad", [(4, 0), (8, 3), (12, 0)])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_plain_matches_jax_reference(b, pad, start):
    rng = np.random.default_rng(100 * b + pad)
    S, lams = _lanes(rng, 3, b, pad=pad)
    W0, T0 = (_cold_pair if start == "cold" else _warm_pair)(S, lams)
    t_jax, sw_jax, t_pt, sw_pt = _both(S, lams, W0, T0)
    assert np.array_equal(sw_pt, sw_jax)
    np.testing.assert_allclose(t_pt, t_jax, rtol=0, atol=ATOL)
    if pad:  # padded coordinates are screened no-ops: exact zeros off-diagonal
        assert (t_pt[:, b - pad:, : b - pad] == 0).all()
    for i in range(len(S)):
        res = float(jax_kkt_residual(jnp.asarray(S[i]), jnp.asarray(t_pt[i]), lams[i]))
        assert res < 1e-5 * np.abs(S[i]).max()


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    S, lams = _lanes(rng, 2, 8)
    W0, T0 = _cold_pair(S, lams)
    scales = _scales(S)
    args = tuple(jnp.asarray(x) for x in (S, lams, scales, W0, T0))
    t_pl, sw_pl = fused_bcd_pallas(
        args[0], args[1].reshape(2, 1), args[2].reshape(2, 1), args[3], args[4],
        interpret=True,
    )
    t_pt, sw_pt = fused_bcd_ref_stack(*(torch.as_tensor(x) for x in (S, lams, scales, W0, T0)))
    assert np.array_equal(sw_pt.numpy(), np.asarray(sw_pl).reshape(2))
    np.testing.assert_allclose(t_pt.numpy(), np.asarray(t_pl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("warm", [False, True])
def test_bcd_solver_reproduces_glasso_bcd(warm):
    """The port's bcd solver — the kernel fed the cold pair and the scale at
    the padded size — gives the reference ``glasso_bcd`` answer, cold and
    with a W0 warm start."""
    rng = np.random.default_rng(9)
    S, lams = _lanes(rng, 3, 8, pad=2)
    W0 = _warm_pair(S, lams)[0] if warm else None
    want = np.stack([
        np.asarray(glasso_bcd(
            jnp.asarray(S[i]), lams[i], W0=None if W0 is None else jnp.asarray(W0[i])
        ))
        for i in range(3)
    ])
    got = glasso_bcd_stack(
        torch.as_tensor(S), torch.as_tensor(lams),
        W0=None if W0 is None else torch.as_tensor(W0),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_options_and_single_lane():
    """max_sweeps / n_cd / node_screen reach the loop; the single-lane form
    equals its stack of one; the inner-sweep count is reported."""
    rng = np.random.default_rng(4)
    S, lams = _lanes(rng, 2, 6)
    W0, T0 = _cold_pair(S, lams)
    args = [torch.as_tensor(x) for x in (S, lams, _scales(S), W0, T0)]
    _, sw1 = fused_bcd_ref_stack(*args, max_sweeps=1)
    assert sw1.tolist() == [1, 1]
    cd = torch.zeros(2, dtype=torch.int64)
    t_ns, sw_ns = fused_bcd_ref_stack(*args, node_screen=False, cd_sweeps=cd)
    t_ns_jax, sw_ns_jax = jax_ref_stack(
        *(jnp.asarray(x) for x in (S, lams, _scales(S), W0, T0)), node_screen=False
    )
    assert np.array_equal(sw_ns.numpy(), np.asarray(sw_ns_jax))
    np.testing.assert_allclose(t_ns.numpy(), np.asarray(t_ns_jax), rtol=0, atol=ATOL)
    assert (cd >= sw_ns.to(torch.int64) * 6).all()  # >= 1 inner sweep per column
    t1, s1 = fused_bcd_single(args[0][0], lams[0], args[2][0], args[3][0], args[4][0])
    t2, s2 = fused_bcd_ref_stack(*(a[:1] for a in args))
    assert torch.equal(t1, t2[0]) and int(s1) == int(s2[0])
    t3, s3 = fused_bcd_stack(*args)  # the wrapper on CPU is the plain version
    t4, s4 = fused_bcd_ref_stack(*args)
    assert torch.equal(t3, t4) and torch.equal(s3, s4)
