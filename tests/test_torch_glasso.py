"""The port's dense ``glasso(S, lam)`` against the reference package.

Each case feeds the same numpy S and lambda to ``repro.core.glasso`` and to
``repro_torch.glasso(..., device="cpu")`` (the plain-PyTorch versions of
the kernels) and requires: identical canonical labels and route mix, Theta
within 1e-9 absolute (both run the same float64 algorithms; only the order
of sums differs, ~1e-16 per operation, carried through the BCD sweeps),
and both results within the reference's ``kkt_residual`` bound.  Mirrors
tests/test_theorem1.py, test_solvers.py and test_closed_form.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro.core import glasso as jax_glasso
from repro.core.solvers.kkt import kkt_residual
from repro.covariance import lambda_interval_for_k, paper_synthetic, structured_synthetic
from repro.engine import EngineOptions as JaxOptions
from repro_torch import EngineOptions
from repro_torch.core import instrument

ATOL = 1e-9
CPU = EngineOptions(device="cpu")


def _kkt(S, Theta, lam):
    return float(kkt_residual(jnp.asarray(S), jnp.asarray(Theta), lam, zero_tol=1e-12))


def _compare(S, lam, jax_opts=None, **kw):
    """Solve with both packages from one options value; returns (port, ref)."""
    jax_opts = jax_opts or JaxOptions()
    d = dataclasses.asdict(jax_opts)
    ref = jax_glasso(S, lam, options=jax_opts, **kw)
    got = repro_torch.glasso(
        S, lam, options=EngineOptions.from_reference(d, device="cpu"), **kw
    )
    assert np.array_equal(got.labels, ref.labels)
    assert got.route_mix == ref.route_mix
    np.testing.assert_allclose(got.Theta, ref.Theta, rtol=0, atol=ATOL)
    bound = 1e-5 * max(1.0, float(np.abs(S).max()))
    assert _kkt(S, got.Theta, lam) <= bound
    assert _kkt(S, ref.Theta, lam) <= bound
    return got, ref


@pytest.mark.parametrize(
    "p,seed,q", [(4, 0, 0.3), (7, 1, 0.5), (10, 2, 0.8), (14, 3, 0.9), (12, 4, 0.95)]
)
def test_random_covariance_matches_reference(p, seed, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    _compare(S, lambda_between_edges(S, q))


@pytest.mark.parametrize("K,p1", [(2, 5), (3, 6)])
def test_paper_synthetic_lambda_I_and_II(K, p1):
    """Theorem 1 on the paper's Section-4.1 construction: exactly K
    components at lambda_I and lambda_II, same blocks as the reference."""
    S = paper_synthetic(K, p1, seed=1)
    lam_min, lam_max = lambda_interval_for_k(S, K)
    lam_II = lam_max - 0.02 * (lam_max - lam_min)
    for lam in (0.5 * (lam_min + lam_max), lam_II):
        got, _ = _compare(S, lam)
        assert got.screen.n_components == K


def test_structured_synthetic_matches_reference():
    S = structured_synthetic(12, 12, seed=0)
    got, _ = _compare(S, 0.6)
    assert {"pair", "tree", "general", "singleton"} <= set(got.route_mix)


def _mixed_structure_covariance():
    """2 singletons + pair + tree(4) + chordal(4) + chordless 5-cycle
    (the reference's tests/test_closed_form.py case)."""
    p = 17
    S = np.eye(p) * 2.0

    def setv(i, j, v):
        S[i, j] = S[j, i] = v

    setv(2, 3, 0.8)
    setv(4, 5, 0.7), setv(5, 6, -0.6), setv(5, 7, 0.5)
    for a, b in [(8, 9), (9, 10), (10, 11), (11, 8), (8, 10)]:
        setv(a, b, 0.45 * (1 if (a + b) % 2 else -1))
    cyc = [12, 13, 14, 15, 16]
    for k in range(5):
        setv(cyc[k], cyc[(k + 1) % 5], 0.5)
    return S, 0.3


def test_every_structure_class_routes_and_matches():
    S, lam = _mixed_structure_covariance()
    instrument.reset("router")
    got, _ = _compare(S, lam)
    mix = instrument.route_mix_counts()
    for cls in ("singleton", "pair", "tree", "chordal", "general"):
        assert mix.get(cls, 0) > 0, f"class {cls} not exercised"
    assert got.route_mix == {
        "singleton": 2, "pair": 1, "tree": 1, "chordal": 1, "general": 1,
    }
    assert 0.0 < got.noniterative_fraction < 1.0
    unrouted = repro_torch.glasso(S, lam, options=CPU.replace(route=False))
    np.testing.assert_allclose(got.Theta, unrouted.Theta, rtol=0, atol=1e-5)
    assert unrouted.noniterative_fraction == 0.0


@pytest.mark.parametrize(
    "structure,S",
    [
        ("tree", [[1.0, 0.9, 0.05], [0.9, 1.0, 0.9], [0.05, 0.9, 1.0]]),
        ("chordal", [[1.0, 0.9, 0.9, 0.05], [0.9, 1.0, 0.9, 0.05],
                     [0.9, 0.9, 1.0, 0.9], [0.05, 0.05, 0.9, 1.0]]),
    ],
)
def test_adversarial_closed_form_falls_back_and_is_repaired(structure, S):
    """The thresholded support is a tree, or chordal (a triangle with a
    pendant), but the optimum is denser: the KKT check rejects the closed
    form and the iterative tail repairs it, warm from the candidate."""
    S = np.array(S)
    lam = 0.1
    instrument.reset("router")
    got, _ = _compare(S, lam)
    assert instrument.count(f"router.fallback.{structure}") == 1
    assert got.route_mix == {structure: 1}
    assert got.Theta[0, -1] != 0.0  # denser than the thresholded support


def test_ties_at_lambda_are_not_edges():
    """lam equal to an existing |S_ij|: strict inequality (eq. (4)) in the
    screen, the classifier and the closed form, as in the reference."""
    S, lam = _mixed_structure_covariance()
    S[0, 1] = S[1, 0] = lam       # would join the two singletons
    S[4, 7] = S[7, 4] = -lam      # would close a cycle in the tree
    got, _ = _compare(S, lam)
    assert got.route_mix["singleton"] == 2 and got.route_mix["tree"] == 1
    assert got.Theta[0, 1] == 0.0
    assert got.screen.n_edges == int((np.triu(np.abs(S), 1) > lam).sum())
    rng = np.random.default_rng(1)
    S = random_covariance(rng, 9)
    lam = float(np.sort(np.abs(S[np.triu_indices(9, 1)]))[-5])  # an exact |S_ij|
    _compare(S, lam)


def test_warm_start_matches_cold():
    rng = np.random.default_rng(4)
    S = random_covariance(rng, 10)
    lam_hi, lam = lambda_between_edges(S, 0.7), lambda_between_edges(S, 0.5)
    W_hi = np.linalg.inv(repro_torch.glasso(S, lam_hi, options=CPU).Theta)
    cold = repro_torch.glasso(S, lam, options=CPU.replace(tol=1e-10))
    warm = repro_torch.glasso(S, lam, warm_W=W_hi, options=CPU.replace(tol=1e-10))
    np.testing.assert_allclose(warm.Theta, cold.Theta, rtol=0, atol=1e-6)
    ref = jax_glasso(S, lam, warm_W=W_hi, options=JaxOptions(solver_opts={"tol": 1e-10}))
    np.testing.assert_allclose(warm.Theta, ref.Theta, rtol=0, atol=ATOL)


def test_unscreened_and_unrouted_baselines_match_reference():
    rng = np.random.default_rng(5)
    S = random_covariance(rng, 8)
    lam = lambda_between_edges(S, 0.6)
    _compare(S, lam, screen=False)
    _compare(S, lam, jax_opts=JaxOptions(route=False))


def test_isolated_nodes_closed_form():
    rng = np.random.default_rng(3)
    S = random_covariance(rng, 6)
    lam = float(np.abs(S - np.diag(np.diag(S))).max() * 1.01)
    got, _ = _compare(S, lam)
    np.testing.assert_allclose(got.Theta, np.diag(1.0 / (np.diag(S) + lam)), rtol=1e-12)


def test_names_and_unported_features_raise():
    S, lam = _mixed_structure_covariance()
    with pytest.raises(ValueError, match="unknown solver 'nope'; available"):
        repro_torch.glasso(S, lam, options=CPU.replace(solver="nope"))
    # the wave packer's solver is ported: the same bits as "bcd"
    fused = repro_torch.glasso(S, lam, options=CPU.replace(solver="fused_bcd"))
    plain = repro_torch.glasso(S, lam, options=CPU.replace(solver="bcd"))
    assert np.array_equal(fused.labels, plain.labels)
    assert np.array_equal(fused.Theta, plain.Theta)
    with pytest.raises(ValueError, match="unknown cc backend 'nope'"):
        repro_torch.glasso(S, lam, options=CPU.replace(cc_backend="nope"))
    with pytest.raises(ValueError, match="p_max"):
        repro_torch.glasso(S, lam, p_max=3, options=CPU)
    # the lambda path is ported: from S and from X it equals the reference's
    from repro.core import glasso_path as jax_glasso_path

    for kw in (dict(S=S), dict(X=S, from_data=True)):
        got = repro_torch.glasso_path(lambdas=[lam, 0.5 * lam], options=CPU, **kw)
        want = jax_glasso_path(lambdas=[lam, 0.5 * lam], **kw)
        assert [r.lam for r in got] == [r.lam for r in want] == [lam, 0.5 * lam]
        for g, w in zip(got, want):
            assert np.array_equal(g.labels, w.labels) and g.route_mix == w.route_mix
            np.testing.assert_allclose(g.Theta, np.asarray(w.Theta), rtol=0, atol=1e-7)
    # sparse results are ported: both entry points return a SparseTheta
    from repro_torch.core.sparse import AUTO_SPARSE_P, SparseTheta, resolve_output

    for kw in (dict(S=S), dict(X=S)):
        r = repro_torch.glasso(lam=lam, options=CPU.replace(output="sparse"), **kw)
        assert isinstance(r.Theta, SparseTheta) and r.output == "sparse"

    assert resolve_output("auto", AUTO_SPARSE_P) == "dense"
    assert resolve_output("auto", AUTO_SPARSE_P + 1) == "sparse"


def test_options_mirror_reference():
    """from_reference takes dataclasses.asdict of the reference options
    (dtype by name); validation messages are the reference's."""
    ref = JaxOptions(route=False, route_check_tol=1e-7, solver_opts={"tol": 1e-9})
    port = EngineOptions.from_reference(
        {**dataclasses.asdict(ref), "dtype": "float64"}, device="cpu"
    )
    assert port.route is False and port.solver_opts == {"tol": 1e-9}
    assert port.resolved_dtype() == torch.float64 and port.device == "cpu"
    assert EngineOptions().device == "cuda"
    for bad in ({"output": "csr"}, {"fused": "yes"}, {"trace": "x"}):
        with pytest.raises(ValueError) as e_ref:
            JaxOptions(**bad)
        with pytest.raises(ValueError) as e_port:
            EngineOptions(**bad)
        assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match="unknown EngineOptions field"):
        EngineOptions.from_reference({"bogus": 1})
    with pytest.warns(DeprecationWarning, match="glasso"):
        r = repro_torch.glasso(*_mixed_structure_covariance(), device="cpu")
    assert r.device == "cpu"


def test_partition_helpers_match_reference():
    """The port's copies of the edge-sorted partition pass (Theorem 2
    snapshots), the merge profile and the capacity lambda agree with the
    reference on the same S."""
    from repro.core import partition as jp
    from repro_torch.core import partition as tp
    from repro_torch.core.schedule import feasible_lambda

    rng = np.random.default_rng(8)
    S = random_covariance(rng, 12)
    lams = [lambda_between_edges(S, q) for q in (0.9, 0.5, 0.2)]
    for a, b in zip(tp.labels_at_thresholds(S, lams), jp.labels_at_thresholds(S, lams)):
        assert np.array_equal(a, b)
    for key, v in jp.merge_profile(S).items():
        assert np.array_equal(tp.merge_profile(S)[key], v)
    assert feasible_lambda(S, 4) == jp.lambda_for_max_component(S, 4)
