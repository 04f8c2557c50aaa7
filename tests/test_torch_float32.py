"""float32 solves: the port against the reference package at
``EngineOptions(dtype="float32")``, on the CPU (the kernels' float32 plain
versions; the card's float32 kernel instances are held to those in
``test_torch_cuda_kernels.py``).

Workload: ``structured_synthetic(K=12, p1=10, seed=0)`` at lam = 0.6, which
has pair, tree and general blocks.  Tolerances, from the float32 arithmetic
of each solver:

* ``bcd``: Theta within 1e-9 (measured 8.7e-11: the float32 BCD sweeps
  round alike in both packages, only sums differ in order);
* ``admm``: Theta within 1e-6 (measured 1.3e-7: float32 eigh and the
  residual sums differ in their last bits and the adaptive rho follows);
* ``pg``: the line search's acceptance test f(cand) <= quad + 1e-12 is
  decided by float32 rounding where f(cand) and quad tie, so the two
  packages part at the first such tie (the 1e-12 slack is far below one
  float32 ulp of f).  The test finds that iteration and shows both sides of
  the test lie within float32 rounding there; neither package's rule
  changes.  The port's result must then meet the KKT check no worse than
  the reference's own float32 result, both measured against the float64
  ``bcd`` solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import glasso as jax_glasso
from repro.core.solvers import pg as jax_pg
from repro.core.solvers.kkt import kkt_residual
from repro.engine.options import EngineOptions as JaxOptions
from repro_torch.core.components import component_lists
from repro_torch.core.solvers import pg as torch_pg
from repro_torch.core.screening import thresholded_components
from repro_torch.covariance import structured_synthetic

LAM = 0.6
THETA_ATOL = {"bcd": 1e-9, "admm": 1e-6}
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    S = structured_synthetic(12, 10, seed=0)
    ref64 = jax_glasso(S, LAM, options=JaxOptions(solver="bcd"))
    return S, np.asarray(ref64.Theta)


def _pair(S, solver):
    ref = jax_glasso(S, LAM, options=JaxOptions(solver=solver, dtype="float32"))
    port = repro_torch.glasso(
        S, LAM, options=repro_torch.EngineOptions(solver=solver, dtype="float32", device="cpu")
    )
    return ref, port


@pytest.mark.parametrize("solver", ["bcd", "admm"])
def test_float32_solves_match_reference(case, solver):
    S, _ = case
    ref, port = _pair(S, solver)
    assert port.Theta.dtype == np.float32 and np.asarray(ref.Theta).dtype == np.float32
    assert np.array_equal(port.labels, np.asarray(ref.labels))
    assert port.route_mix == ref.route_mix and len(port.route_mix) >= 3
    got = port.Theta.astype(np.float64)
    want = np.asarray(ref.Theta, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_ATOL[solver])


def test_float32_pg_meets_kkt_no_worse_than_reference(case):
    S, theta64 = case
    ref, port = _pair(S, "pg")
    got = port.Theta.astype(np.float64)
    want = np.asarray(ref.Theta, dtype=np.float64)
    kkt_port = float(kkt_residual(S, got, LAM))
    kkt_ref = float(kkt_residual(S, want, LAM))
    assert kkt_port <= kkt_ref
    assert np.abs(got - theta64).max() <= np.abs(want - theta64).max()


def _ref_trace(B, lam, iters):
    """The reference's pg iteration (``repro.core.solvers.pg.glasso_pg``)
    written out step by step with its own primitives: per iteration, every
    line-search candidate's (f(cand), quad, accepted)."""
    S = jnp.asarray(B)
    lam = jnp.float32(lam)
    b = B.shape[0]
    Theta = jnp.where(jnp.eye(b, dtype=bool), 1.0 / (jnp.diag(S) + lam), jnp.zeros_like(S))
    t = jnp.asarray(1.0, S.dtype) / (jnp.linalg.norm(S) + 1.0)
    trace = []
    for _ in range(iters):
        _, logdet, inv = jax_pg._chol_logdet_inv(Theta)
        grad = S - inv
        fcur = -logdet + jnp.sum(S * Theta)
        tt, steps = t * 2.0, []
        for _ in range(31):
            cand = jax_pg._soft(Theta - tt * grad, tt * lam)
            okc, logdetc, _ = jax_pg._chol_logdet_inv(cand)
            diff = cand - Theta
            quad = fcur + jnp.sum(grad * diff) + jnp.sum(diff * diff) / (2.0 * tt)
            f = -logdetc + jnp.sum(S * cand)
            good = bool(okc) and bool(f <= quad + 1e-12)
            steps.append((float(f), float(quad), good))
            tt = tt * 0.5
            if good:
                break
        trace.append(steps)
        Theta = jnp.where(good, cand, Theta)
        t = jnp.clip(tt * 4.0, 1e-12, 1e6)
    return trace


def _port_trace(B, lam, iters):
    """The port's ``glasso_pg_stack`` for one lane, step by step with its
    own primitives (the ``prox_l1`` plain version on the CPU)."""
    S = torch.as_tensor(B)[None]
    lamt = torch.tensor([lam], dtype=torch.float32)
    Theta = torch.diag_embed(1.0 / (S.diagonal(dim1=1, dim2=2) + lamt[:, None]))
    t = 1.0 / (torch.linalg.matrix_norm(S) + 1.0)
    trace = []
    for _ in range(iters):
        _, logdet, inv = torch_pg.chol_logdet_inv(Theta)
        grad = S - inv
        fcur = torch_pg._f_val(S, logdet, Theta)
        tt, steps = 2.0 * t, []
        for _ in range(31):
            cand = torch_pg.prox_step(Theta, grad, tt, lamt)
            okc, logdetc, _ = torch_pg.chol_logdet_inv(cand, inverse=False)
            diff = cand - Theta
            quad = fcur + (grad * diff).sum(dim=(1, 2)) + (diff * diff).sum(dim=(1, 2)) / (2.0 * tt)
            f = torch_pg._f_val(S, logdetc, cand)
            good = bool(okc & (f <= quad + 1e-12))
            steps.append((float(f), float(quad), good))
            tt = 0.5 * tt
            if good:
                break
        trace.append(steps)
        if good:
            Theta = cand
        t = torch.clamp(4.0 * tt, 1e-12, 1e6)
    return trace


def test_float32_pg_parts_from_reference_on_a_float32_tie(case):
    """On the 7-vertex block, find the first iteration at which the two line
    searches accept a different candidate, anchor it to the solvers
    themselves, and show that f(cand) - quad of the candidate they decide
    differently lies within float32 rounding on both sides."""
    S, _ = case
    labels, _ = thresholded_components(S, LAM)
    comp = next(c for c in component_lists(labels) if len(c) == 7)
    B = S[np.ix_(comp, comp)].astype(np.float32)
    ref_tr, port_tr = _ref_trace(B, LAM, 50), _port_trace(B, LAM, 50)
    first = next(
        i for i, (r, p) in enumerate(zip(ref_tr, port_tr))
        if [s[2] for s in r] != [s[2] for s in p]
    )
    r, p = ref_tr[first], port_tr[first]
    k = next(j for j, (a, b) in enumerate(zip(r, p)) if a[2] != b[2])
    (f_r, q_r, _), (f_p, q_p, _) = r[k], p[k]
    ulp = EPS32 * max(abs(f_r), abs(q_r), abs(f_p), abs(q_p))
    # a tie in float32: each side's f - quad, and their difference, within
    # two ulps of f; the 1e-12 slack cannot tell them apart
    assert abs(f_r - q_r) <= 2 * ulp and abs(f_p - q_p) <= 2 * ulp
    assert abs((f_r - q_r) - (f_p - q_p)) <= 2 * ulp
    assert 1e-12 < 1e-3 * ulp
    # the solvers themselves: together (to float32 rounding) through that
    # iteration's start, parted after it
    lam_t = torch.tensor([LAM], dtype=torch.float32)

    def both(iters):
        ref = np.asarray(jax_pg.glasso_pg(jnp.asarray(B), jnp.float32(LAM), max_iter=iters, tol=0.0))
        port = torch_pg.glasso_pg_stack(torch.as_tensor(B)[None], lam_t, max_iter=iters, tol=0.0)
        return float(np.abs(ref - port[0].numpy()).max()), float(np.abs(ref).max())

    before, scale = both(first)
    after, _ = both(first + 1)
    assert before <= 16 * EPS32 * scale < after
