"""The port's fused wave packer against its unfused dispatch and against
the reference package (``tests/test_fused.py``'s cases, on the CPU).

The packer's contract is exactness: re-packing small iterative buckets
across bucket boundaries into size-binned stacks, one ``bucket_glasso``
call a bin, must reproduce the per-bucket dispatches bit for bit
(``np.array_equal``; -0.0 == +0.0).  That rests on the plain version's
sums being independent of trailing zero padding (``repad_stack`` below),
on each lane's convergence scale being taken at its source shape, and on
cold lanes carrying the pair the unfused solve builds.  Against the
reference the usual tolerance holds: labels and route mixes equal, Theta
within THETA_ATOL = 1e-7 (the float64 plain versions add in another order;
``tests/test_torch_path.py`` says why 1e-7).
"""

import numpy as np
import pytest
import torch

from repro.core import glasso as jax_glasso, glasso_path as jax_glasso_path
from repro.engine import EngineOptions as JaxOptions
from repro.engine.api import Engine as JaxEngine
from repro_torch import EngineOptions, glasso, glasso_path
from repro_torch.core import instrument
from repro_torch.core.solvers.bcd import convergence_scale
from repro_torch.engine.api import Engine
from repro_torch.engine.registry import ROUTES, set_route
from repro_torch.engine.waves import FUSED_BINS, fused_bin, repad_stack
from repro_torch.kernels.bucket_glasso import fused_bcd_ref_stack

THETA_ATOL = 1e-7
CPU = EngineOptions(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain version's loops run thousands of tiny batched operations;
    torch's worker threads only spin on them and starve the parallel test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planted_general_blocks(sizes, seed=0, cross=0.0):
    """Block-diagonal S whose blocks are chordless cycles (structure
    "general" for size >= 4).  Entries are dyadic (multiples of 1/64), so
    |S_ij| == lam ties are exact in every cc backend's arithmetic;
    ``cross`` plants dyadic couplings between consecutive blocks."""
    rng = np.random.default_rng(seed)
    p = int(sum(sizes))
    S = np.zeros((p, p))
    off = 0
    starts = []
    for b in sizes:
        starts.append(off)
        for i in range(b):
            j = (i + 1) % b
            mag = rng.integers(24, 33) / 64.0  # in [0.375, 0.5], dyadic
            sgn = 1.0 if rng.random() < 0.5 else -1.0
            S[off + i, off + j] = S[off + j, off + i] = sgn * mag
        off += b
    if cross:
        for a, b in zip(starts, starts[1:]):
            S[a, b] = S[b, a] = cross
    np.fill_diagonal(S, 1.0)
    return S


# every bin, several buckets a bin (sizes 4 and 5-8 share bin 8), and
# single-block buckets (12, 20, 36)
MIXED_SIZES = [4, 4, 4, 5, 7, 7, 12, 20, 36]


def _same_bits(a, b):
    assert np.array_equal(a.labels, b.labels)
    assert a.route_mix == b.route_mix
    assert np.array_equal(a.Theta, b.Theta)


def _near_reference(got, ref):
    assert np.array_equal(got.labels, np.asarray(ref.labels))
    assert got.route_mix == ref.route_mix
    np.testing.assert_allclose(got.Theta, np.asarray(ref.Theta), rtol=0, atol=THETA_ATOL)


@pytest.mark.parametrize("backend", ("host", "jax", "pallas"))
def test_fused_bitwise_equals_unfused_per_backend(backend):
    """One plan step over every bin, a dyadic tie |S_ij| == lam: the
    packed launches reproduce the per-bucket ones bit for bit under every
    ported screening backend, and agree with the reference's fused solve."""
    S = planted_general_blocks(MIXED_SIZES, seed=1, cross=0.25)
    lam = 0.25  # == the planted cross coupling: an exact eq.-(4) tie
    base = CPU.replace(cc_backend=backend)
    r_un = glasso(S, lam, options=base)
    r_f = glasso(S, lam, options=base.replace(fused=True))
    _same_bits(r_un, r_f)
    ref = jax_glasso(S, lam, options=JaxOptions(cc_backend=backend, fused=True))
    _near_reference(r_f, ref)


def test_fused_warm_path_with_midgrid_merges_bitwise():
    """A descending grid whose components merge mid-path: the warm fused
    path equals the warm unfused path bit for bit at every grid point
    (reused buckets' kept solutions, merged buckets' gathered stacks and
    the cold first point all pack), and the reference's within tolerance."""
    S = planted_general_blocks([4, 5, 6, 7, 4, 9], seed=2, cross=0.25)
    lams = [0.45, 0.35, 0.25, 0.2]  # merges at the 0.25 tie
    opts = CPU.replace(solver_opts={"tol": 1e-7})
    instrument.reset("select.warm.")
    p_un = glasso_path(S, lams, options=opts)
    warm_un = instrument.counts("select.warm.")
    instrument.reset("select.warm.")
    p_f = glasso_path(S, lams, options=opts.replace(fused=True))
    assert instrument.counts("select.warm.") == warm_un
    assert warm_un.get("select.warm.merged", 0) > 0 and warm_un.get("select.warm.reused", 0) > 0
    assert len(np.unique(p_un[-1].labels)) < len(np.unique(p_un[0].labels))
    for a, b in zip(p_un, p_f):
        _same_bits(a, b)
    ref = jax_glasso_path(S, lams, options=JaxOptions(solver_opts={"tol": 1e-7}, fused=True))
    for g, r in zip(p_f, ref):
        _near_reference(g, r)


def test_fused_solver_and_route_are_bitwise_too():
    """solver="fused_bcd" and set_route("general", "fused") give the same
    bits as the unfused solve, and the reference's within tolerance."""
    S = planted_general_blocks([4, 4, 6, 11], seed=3)
    lam = 0.3
    r_un = glasso(S, lam, options=CPU)
    instrument.reset("solver.fused.")
    r_solver = glasso(S, lam, options=CPU.replace(solver="fused_bcd"))
    assert instrument.count("solver.fused.dispatches") == 2  # bins 8 and 16
    _same_bits(r_un, r_solver)
    assert r_solver.solver == "fused_bcd"
    set_route("general", "fused")
    try:
        instrument.reset("solver.fused.")
        r_route = glasso(S, lam, options=CPU)
        assert instrument.count("solver.fused.dispatches") == 2
        assert r_route.noniterative_fraction == 0.0
        ref = jax_glasso(S, lam, options=JaxOptions())
    finally:
        set_route("general", "iterative")
    _same_bits(r_un, r_route)
    _near_reference(r_route, ref)
    _near_reference(r_solver, jax_glasso(S, lam, options=JaxOptions(solver="fused_bcd")))


def test_single_lane_buckets_fuse_bitwise():
    """Buckets of one block each: a megabatch of single lanes equals the
    unfused one-lane launches."""
    S = planted_general_blocks([4, 5, 6, 7], seed=4)
    r_un = glasso(S, 0.3, options=CPU)
    r_f = glasso(S, 0.3, options=CPU.replace(fused=True))
    _same_bits(r_un, r_f)
    _near_reference(r_f, jax_glasso(S, 0.3, options=JaxOptions(fused=True)))


def test_fused_counters_and_dispatch_collapse():
    """One launch per occupied bin: solver.fused.dispatches equals the
    occupied bins (the reference's count too), blocks_packed counts every
    general block, bucket_glasso runs once a bin instead of once a bucket,
    and the dispatch stage is attributed on the result."""
    sizes = MIXED_SIZES
    S = planted_general_blocks(sizes, seed=5)
    bins_occupied = {fused_bin(s) for s in sizes}
    calls = []
    import repro_torch.core.solvers.bcd as bcd_mod

    inner = bcd_mod.fused_bcd_stack

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return inner(*args, **kwargs)

    bcd_mod.fused_bcd_stack = counting
    try:
        r_un = glasso(S, 0.3, options=CPU)
        n_unfused = len(calls)
        calls.clear()
        for prefix in ("solver.fused.", "engine.dispatch."):
            instrument.reset(prefix)
        r = glasso(S, 0.3, options=CPU.replace(fused=True))
    finally:
        bcd_mod.fused_bcd_stack = inner
    assert n_unfused == len({(b.size) for b in _plan_buckets(S, 0.3)}) > len(bins_occupied)
    assert len(calls) == len(bins_occupied)
    assert sorted(c[1] for c in calls) == sorted(bins_occupied)
    assert instrument.count("solver.fused.dispatches") == len(bins_occupied)
    assert instrument.count("solver.fused.blocks_packed") == len(sizes)
    assert instrument.count("solver.fused.lockstep_sweeps_saved") >= 0
    assert instrument.count("engine.dispatch.count") >= len(bins_occupied)
    assert instrument.count("engine.dispatch.us") > 0
    assert r.dispatch_seconds > 0.0 and "dispatch_us" in r.stages_us
    _same_bits(r_un, r)

    from repro.core.instrument import count as jax_count, reset as jax_reset

    jax_reset("solver.fused.")
    jax_glasso(S, 0.3, options=JaxOptions(fused=True))
    assert jax_count("solver.fused.dispatches") == len(bins_occupied)
    assert jax_count("solver.fused.blocks_packed") == len(sizes)


def _plan_buckets(S, lam):
    from repro_torch.core.screening import thresholded_components
    from repro_torch.engine.planner import build_plan_incremental

    labels, _ = thresholded_components(S, lam)
    return build_plan_incremental(S, lam, labels)[0].buckets


def test_unrouted_pairs_and_node_screen_off_fuse_bitwise():
    """route=False sends pairs (bucket size 2) and every other block down
    the iterative tail, so size-2 and size-4 buckets re-pad into bin 8;
    node_screen=False runs the padded columns' lasso too.  Both stay
    bitwise."""
    S = planted_general_blocks([2, 3, 4, 6], seed=6)
    for opts in (CPU.replace(route=False), CPU.replace(solver_opts={"node_screen": False})):
        r_un = glasso(S, 0.3, options=opts)
        instrument.reset("solver.fused.")
        r_f = glasso(S, 0.3, options=opts.replace(fused=True))
        assert instrument.count("solver.fused.dispatches") == 1
        _same_bits(r_un, r_f)


def test_diverged_warm_lane_is_resolved_cold_when_fused():
    """The warm lane that diverges after a large drop in lambda
    (``tests/test_torch_path.py``) is a fused lane here: it is re-solved
    cold the same way, and the whole path keeps the unfused bits."""
    from test_torch_path import _factor_data

    from repro_torch.covariance import sample_covariance
    from conftest import lambda_between_edges

    X = _factor_data(seed=1)
    S = sample_covariance(X, device="cpu").numpy()
    lams = [lambda_between_edges(S, q) for q in (0.98, 0.93, 0.85, 0.7)]
    opts = CPU.replace(solver_opts={"tol": 1e-9})
    instrument.reset("")
    p_un = glasso_path(S, lams, options=opts)
    assert instrument.count("router.fallback.warm") == 1
    instrument.reset("")
    p_f = glasso_path(S, lams, options=opts.replace(fused=True))
    assert instrument.count("router.fallback.warm") == 1
    assert instrument.count("solver.fused.dispatches") > 0
    for a, b in zip(p_un, p_f):
        _same_bits(a, b)


def test_fused_options_and_registry_surface():
    """The route, the bins, the option's values and errors, word for word
    the reference's."""
    from repro.engine.registry import ROUTES as JAX_ROUTES
    from repro.engine.waves import FUSED_BINS as JAX_BINS, fused_bin as jax_fused_bin

    assert ROUTES == JAX_ROUTES and "fused" in ROUTES
    assert FUSED_BINS == JAX_BINS
    for s in (1, 2, 8, 9, 33, 64, 65, 200):
        assert fused_bin(s) == jax_fused_bin(s)
        if s <= 64:
            assert fused_bin(s) in FUSED_BINS and fused_bin(s) >= s
    assert fused_bin(65) is None
    # the plain version's dot products are padded to the largest bin, so a
    # lane at its size and at its bin sums the same terms in the same order
    from repro_torch.kernels.bucket_glasso.ref import SUM_WIDTH

    assert SUM_WIDTH == FUSED_BINS[-1]
    with pytest.raises(ValueError, match="fused must be"):
        EngineOptions(fused="yes")
    with pytest.raises(ValueError, match="fused_stack") as e_port:
        Engine(options=CPU.replace(solver="pg", fused=True))
    with pytest.raises(ValueError, match="fused_stack") as e_ref:
        JaxEngine(options=JaxOptions(solver="pg", fused=True))
    assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match="unknown route"):
        set_route("general", "nope")
    # "auto" fuses only for the solver that forces it; admm never fuses
    assert Engine(options=CPU).executor.fused is False
    assert Engine(options=CPU.replace(solver="fused_bcd")).executor.fused is True
    assert Engine(options=CPU.replace(fused=True)).executor.fused is True
    assert Engine(options=CPU.replace(solver="fused_bcd", fused=False)).executor.fused is False
    assert Engine(options=CPU.replace(solver="admm")).executor._fused_capable is False
    assert Engine(options=CPU.replace(fused=True, solver_opts={"tol": 1e-8})).executor._fused_capable
    S = planted_general_blocks([4, 6], seed=8)
    instrument.reset("solver.fused.")
    glasso(S, 0.3, options=CPU.replace(solver="admm", solver_opts={"tol": 1e-8}))
    glasso(S, 0.3, options=CPU.replace(solver="fused_bcd", fused=False))
    assert instrument.count("solver.fused.dispatches") == 0


def _cov(rng, p):
    X = rng.standard_normal((2 * p + 8, p)) @ (np.eye(p) + 0.3 * rng.standard_normal((p, p)))
    return np.cov(X, rowvar=False, bias=True)


@pytest.mark.parametrize("sizes", [tuple(range(2, 12)), tuple(range(12, 21)), (33, 50)])
def test_repad_stack_keeps_the_plain_version_bitwise(sizes):
    """The plain bucket_glasso at a lane's own size s and re-padded to its
    bin (identity S and T0, 1 + lam on W0, the scale at the source size)
    gives equal bits and sweep counts, cold and warm, for every s in
    2-20 and for s = 33 and 50 (bin 64)."""
    for s in sizes:
        rng = np.random.default_rng(s)
        bin_ = fused_bin(s)
        S = torch.as_tensor(np.stack([_cov(rng, s) for _ in range(2)]))
        off = np.abs(S[0].numpy()[np.triu_indices(s, 1)])
        lam = float(np.quantile(off, 0.9 if s > 32 else 0.7))
        lams = torch.full((2,), lam, dtype=torch.float64)
        scales = convergence_scale(S)
        eye = torch.eye(s, dtype=torch.float64)
        W_cold, T_cold = S + lams[:, None, None] * eye, eye.expand(2, s, s)
        T_warm, _ = fused_bcd_ref_stack(S, 1.2 * lams, scales, W_cold, T_cold)
        for W0, T0 in ((W_cold, T_cold), (torch.linalg.inv(T_warm), T_warm)):
            cd = torch.zeros(2, dtype=torch.int64)
            t_s, sw_s = fused_bcd_ref_stack(S, lams, scales, W0, T0, cd_sweeps=cd)
            cd_bin = torch.zeros(2, dtype=torch.int64)
            t_b, sw_b = fused_bcd_ref_stack(
                repad_stack(S, bin_, 1.0), lams, scales, repad_stack(W0, bin_, 1.0 + lam),
                repad_stack(T0, bin_, 1.0), cd_sweeps=cd_bin,
            )
            assert torch.equal(sw_s, sw_b) and torch.equal(cd, cd_bin), s
            assert torch.equal(t_s, t_b[:, :s, :s]), s
            assert (t_b[:, s:, :s] == 0).all() and (t_b[:, :s, s:] == 0).all()


def test_repad_stack_layout():
    x = torch.arange(8, dtype=torch.float64).reshape(2, 2, 2) + 1
    out = repad_stack(x, 4, 3.0)
    assert out.shape == (2, 4, 4)
    assert torch.equal(out[:, :2, :2], x)
    assert torch.equal(out[:, 2:, 2:], 3.0 * torch.eye(2, dtype=torch.float64).expand(2, 2, 2))
    assert (out[:, :2, 2:] == 0).all() and (out[:, 2:, :2] == 0).all()
    assert repad_stack(x, 2, 3.0) is x
    import jax.numpy as jnp
    from repro.engine.waves import repad_stack as jax_repad

    assert np.array_equal(out.numpy(), np.asarray(jax_repad(jnp.asarray(x.numpy()), 4, 3.0)))
    # the reference's other helpers: the scale at the source shape, and the
    # fused solver with its options bound (one function for every bin)
    from repro.engine.waves import bucket_scales as jax_scales
    from repro_torch.engine.waves import bucket_scales, compiled_fused_solver

    S = torch.as_tensor(np.stack([_cov(np.random.default_rng(k), 5) for k in range(2)]))
    sc = bucket_scales(S)
    assert torch.equal(sc, convergence_scale(S))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jax_scales(jnp.asarray(S.numpy()))),
                               rtol=1e-14)
    lams = torch.full((2,), 0.1, dtype=torch.float64)
    eye = torch.eye(5, dtype=torch.float64)
    args = (S, lams, sc, S + 0.1 * eye, eye.expand(2, 5, 5))
    fn = compiled_fused_solver(8, torch.float64, (("tol", 1e-9),))
    for got, want in zip(fn(*args), fused_bcd_ref_stack(*args, tol=1e-9)):
        assert torch.equal(got, want)
