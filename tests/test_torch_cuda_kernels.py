"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the reference package (the machine with the
card has no JAX), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: ``tree_glasso`` rounds every elementwise product as the plain
version does and only sums rows in another order — 1e-13 of max|Theta|.
``bucket_glasso`` carries the dot products' different summation order
through the BCD sweeps — 1e-9 of max|Theta|, far inside the solver's
convergence tolerance (1e-6 * scale) — and must stop at the same outer and
inner sweep counts lane by lane."""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import instrument
from repro_torch.core.blocks import pad_block
from repro_torch.core.solvers.bcd import convergence_scale
from repro_torch.kernels.bucket_glasso import fused_bcd_ref_stack, fused_bcd_stack
from repro_torch.kernels.tree_glasso import glasso_forest_ref, glasso_forest_stack
from repro_torch.obs.device_profile import profile_calls

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    return torch.device("cuda")


def _covariance(rng, p):
    X = rng.standard_normal((2 * p + 8, p)) @ (np.eye(p) + 0.3 * rng.standard_normal((p, p)))
    return np.cov(X, rowvar=False, bias=True)


def _lam(S, q):
    vals = np.unique(np.abs(S[np.triu_indices(S.shape[0], 1)]))
    k = int(np.clip(q * (vals.size - 1), 0, vals.size - 2))
    return float(0.5 * (vals[k] + vals[k + 1]))


# B = 585 at b = 2: the main path's pair stack, spread over more programs
# than one an SM's worth of 2048 / b^2 blocks each
@pytest.mark.parametrize("B,b", [(37, 2), (37, 5), (37, 8), (37, 33), (37, 64), (37, 384),
                                 (585, 2)])
def test_tree_glasso_matches_plain(cuda_device, B, b):
    """Within 1e-13 of max|Theta| of the plain version for every form of
    lam: one a block, a strided view of one, a Python scalar, a 0-d tensor
    on the card and on the CPU.  A call is one launch and one device event;
    a lam of the wrong shape raises."""
    rng = np.random.default_rng(20 + b)
    blocks = rng.standard_normal((B, b, b))
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    blocks += np.abs(blocks).sum(axis=2).max(axis=1)[:, None, None] * np.eye(b)
    lams = rng.uniform(0.1, 0.6, size=B)
    if b > 2:  # exact ties |S_ij| == lam are not edges
        blocks[:, 0, 1] = blocks[:, 1, 0] = lams
    S = torch.as_tensor(blocks, device=cuda_device)
    lm = torch.as_tensor(lams, device=cuda_device)
    strided = torch.as_tensor(np.repeat(lams, 2), device=cuda_device)[::2]
    forms = [lm, strided, 0.35, torch.tensor(0.35, dtype=torch.float64, device=cuda_device),
             torch.tensor(0.35, dtype=torch.float64)]
    instrument.reset("kernels.")
    got = [glasso_forest_stack(S, lam) for lam in forms]
    torch.cuda.synchronize()
    assert instrument.count("kernels.tree_glasso.launches") == len(forms)
    for out, lam in zip(got, forms):
        want = glasso_forest_ref(S, lam)
        assert float((out - want).abs().max()) <= 1e-13 * float(want.abs().max())
    assert torch.equal(got[0], got[1])
    if b > 2:
        assert (got[0][:, 0, 1] == 0).all()
    for lam in forms:
        events = _device_events(lambda: glasso_forest_stack(S, lam))
        assert len(events) == 1, events
        name, per_call = next(iter(events.items()))
        assert "tree_glasso" in name and 0.0 < per_call <= 1.0, events
    with pytest.raises(ValueError, match="per-block"):
        glasso_forest_stack(S, lm[: B - 1])


def _general_lanes(rng, n, b, lam=0.3):
    """n padded (b, b) lanes of the planner's iterative kind: a chordless
    cycle on 3b/4 vertices plus random chords above lam, everything else
    below it, diagonally dominant."""
    m = max(4, 3 * b // 4)
    out = []
    for _ in range(n):
        S = np.triu(rng.uniform(-0.8 * lam, 0.8 * lam, size=(m, m)), 1)
        edges = [(i, (i + 1) % m) for i in range(m)]
        edges += [tuple(rng.choice(m, size=2, replace=False)) for _ in range(m // 4)]
        for i, j in edges:
            S[min(i, j), max(i, j)] = rng.uniform(lam + 0.05, lam + 0.5) * rng.choice([-1.0, 1.0])
        S = S + S.T
        np.fill_diagonal(S, 1.0 + np.abs(S).sum(axis=1))
        out.append(pad_block(S, b))
    return out, np.full(n, lam), m


def _screened_lane(rng, b, lam):
    """A lane whose every column the eq.-(10) node screen skips: each
    off-diagonal |S_kj| is below lam."""
    S = rng.uniform(-0.9 * lam, 0.9 * lam, size=(b, b))
    S = 0.5 * (S + S.T)
    np.fill_diagonal(S, 1.0 + np.abs(S).sum(axis=1))
    return S


def _w_shared_limit(dtype):
    """The largest b whose W tile stays in the kernel's shared memory."""
    from repro_torch.kernels.bucket_glasso.ops import layout

    b = 1
    while layout(b + 1, dtype)[1] < 3 * (b + 1) ** 2:
        b += 1
    return b


# b = 1 (every column trivially screened); 31, 32, 33 around one chunk of
# rows a lane; 84 / 85 the last b whose four tiles fit shared memory in
# float64 and the first that keeps only W there; "w_max" / "w_max+1" the
# last b whose W fits shared memory and the first whose W goes to device
# scratch (``layout``: b = 168 / 169 in float64); 257 the first b whose
# rows a lane keeps in shared memory rather than registers.  "cov" stacks
# are dense random covariances, "general" ones the planner's general lanes
# (sparse solutions: the plain version takes minutes on dense covariances
# at these sizes).  Every stack carries one more lane that the node screen
# skips in every column.  The float32 instance may stop a sweep earlier or
# later than its plain version (F32_BUCKET_RTOL says why): Theta only.
F64, F32 = torch.float64, torch.float32


@pytest.mark.parametrize("b,N,dtype,data", [
    (1, 8, F64, "cov"), (4, 40, F64, "cov"), (16, 20, F64, "cov"), (31, 6, F64, "cov"),
    (32, 12, F64, "cov"), (33, 6, F64, "cov"), (64, 6, F64, "cov"), (84, 2, F64, "general"),
    (85, 2, F64, "general"), (96, 2, F64, "cov"), (128, 3, F64, "cov"),
    ("w_max", 2, F64, "general"), ("w_max+1", 2, F64, "general"), (257, 1, F64, "general"),
    (32, 12, F32, "cov"), (128, 3, F32, "general"),
])
def test_bucket_glasso_matches_plain(cuda_device, b, N, dtype, data):
    """Cold and warm lanes, identity-padded: sweeps and inner sweeps equal
    (float64), Theta within tolerance, padded cross terms exactly zero, the
    screened lane's Theta diagonal."""
    from repro_torch.kernels.bucket_glasso.ops import layout

    rng = np.random.default_rng(b if isinstance(b, int) else 168)
    if isinstance(b, str):
        b = _w_shared_limit(F64) + (b == "w_max+1")
    if data == "general":
        covs, lams, live = _general_lanes(rng, N, b)
    else:
        live = b - b // 4
        covs = [np.atleast_2d(_covariance(rng, live)) for _ in range(N)]
        lams = np.array([_lam(s, 0.6) if live > 1 else 0.3 for s in covs])
    if dtype == F64:
        assert (layout(b, F64)[1] < 3 * b * b) == (b <= 168)  # W in shared memory
    lams = np.append(lams, lams[0])
    blocks = [pad_block(s, b) for s in covs] + [_screened_lane(rng, b, lams[0])]
    N += 1
    S = torch.as_tensor(np.stack(blocks), device=cuda_device).to(dtype)
    lm = torch.as_tensor(lams, device=cuda_device).to(dtype)
    scales = convergence_scale(S)
    eye = torch.eye(b, dtype=dtype, device=cuda_device)
    W_cold, T_cold = S + lm[:, None, None] * eye, eye.expand(N, b, b).contiguous()
    T_warm, _ = fused_bcd_stack(S, 1.2 * lm, scales, W_cold, T_cold)
    rtol = 1e-9 if dtype == F64 else F32_BUCKET_RTOL
    for W0, T0 in ((W_cold, T_cold), (torch.linalg.inv(T_warm), T_warm)):
        cd = torch.zeros(N, dtype=torch.int64, device=cuda_device)
        got, sw = fused_bcd_stack(S, lm, scales, W0, T0, cd_sweeps=cd)
        got, sw, cd = got.cpu(), sw.cpu(), cd.cpu()
        # the plain version on CPU copies of the same inputs: launch-bound on
        # the card, it takes several times as long there
        cd_ref = torch.zeros_like(cd)
        want, sw_ref = fused_bcd_ref_stack(*(x.cpu() for x in (S, lm, scales, W0, T0)),
                                           cd_sweeps=cd_ref)
        assert got.dtype == dtype
        if dtype == F64:
            assert torch.equal(sw, sw_ref) and torch.equal(cd, cd_ref)
        assert float((got - want).abs().max()) <= rtol * float(want.abs().max())
        assert (got[:-1, live:, :live] == 0).all()
        assert int(cd[-1]) == 0 and (got[-1] == torch.diag_embed(got[-1].diagonal())).all()


# float32 instances of the five solve kernels against their float32 plain
# versions.  prox_l1 and shard_prox's Z'/U' round every operation as the
# plain version does: bit-equal.  tree_glasso sums rows in another order:
# 6e-5 of max|Theta| (~500 float32 epsilons, the float64 check's 1e-13 is
# ~450 float64 epsilons).  bucket_glasso carries the dot products' order
# through the sweeps and may stop a sweep earlier or later: 1e-5 of
# max|Theta| (float32 against float64 plain versions differ by ~1e-7 on
# these lanes).  shard_prox's and joint_prox's residual sums: 1e-5
# relative; joint_prox's Z/U (the group norm sums K squares in another
# order): 1e-5 absolute on values of O(1).
F32_TREE_RTOL = 6e-5
F32_BUCKET_RTOL = 1e-5
F32_SUM_RTOL = 1e-5
F32_JOINT_ATOL = 1e-5


def _f32(*xs):
    return [x.to(torch.float32) for x in xs]


def test_float32_tree_and_bucket_instances_match_plain(cuda_device):
    rng = np.random.default_rng(32)
    B, b = 29, 40
    blocks = rng.standard_normal((B, b, b))
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    blocks += np.abs(blocks).sum(axis=2).max(axis=1)[:, None, None] * np.eye(b)
    S, lm = _f32(torch.as_tensor(blocks, device=cuda_device),
                 torch.as_tensor(rng.uniform(0.1, 0.6, size=B), device=cuda_device))
    instrument.reset("kernels.")
    got = glasso_forest_stack(S, lm)
    want = glasso_forest_ref(S, lm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert instrument.count("kernels.tree_glasso.launches") == 1
    assert float((got - want).abs().max()) <= F32_TREE_RTOL * float(want.abs().max())
    for bb, N in ((16, 20), (32, 12), (96, 3), (128, 2)):  # all four tiles shared, then W alone
        rng = np.random.default_rng(bb)
        live = bb - bb // 4
        covs = [_covariance(rng, live) for _ in range(N)]
        S = torch.as_tensor(np.stack([pad_block(c, bb) for c in covs]), device=cuda_device)
        lm = torch.as_tensor([_lam(c, 0.6) for c in covs], device=cuda_device)
        S, lm = _f32(S, lm)
        eye = torch.eye(bb, dtype=torch.float32, device=cuda_device)
        W0, T0 = S + lm[:, None, None] * eye, eye.expand(N, bb, bb).contiguous()
        scales = convergence_scale(S)
        got, _ = fused_bcd_stack(S, lm, scales, W0, T0)
        want, _ = fused_bcd_ref_stack(S, lm, scales, W0, T0)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= F32_BUCKET_RTOL * float(want.abs().max())
        assert (got[:, live:, :live] == 0).all()


def test_float32_prox_instances_match_plain(cuda_device):
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step
    from repro_torch.kernels.prox_l1 import prox_step, prox_step_ref
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

    rng = np.random.default_rng(33)
    theta, grad = _f32(*(torch.as_tensor(rng.standard_normal((5, 33, 33)), device=cuda_device)
                         for _ in range(2)))
    t_lane, lam_lane = _f32(torch.as_tensor(rng.uniform(0.05, 1.5, 5), device=cuda_device),
                            torch.as_tensor(rng.uniform(0.0, 1.0, 5), device=cuda_device))
    got = prox_step(theta, grad, t_lane, lam_lane)
    assert got.dtype == torch.float32
    assert torch.equal(got, prox_step_ref(theta, grad, t_lane, lam_lane))
    x, u, z = _f32(*(torch.as_tensor(rng.standard_normal((3, 300, 257)), device=cuda_device)
                     for _ in range(3)))
    t = _f32(torch.as_tensor(rng.uniform(0.05, 1.0, 3), device=cuda_device))[0]
    got, want = fused_prox_residual(x, u, z, t), fused_prox_ref(x, u, z, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=F32_SUM_RTOL)
    for penalty in ("group", "fused"):
        for K in (4, 20):
            ops = _f32(*(torch.as_tensor(rng.standard_normal((3, K, 9, 9)), device=cuda_device)
                         for _ in range(3)))
            tt = _f32(torch.as_tensor(np.stack([0.3 * rng.random(3) + 0.01, 0.3 * rng.random(3)],
                                               axis=1), device=cuda_device))[0]
            got = joint_prox_step(*ops, tt, penalty=penalty)
            want = joint_prox_ref(*ops, tt, penalty=penalty)
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == torch.float32
                assert float((g - w).abs().max()) <= F32_JOINT_ATOL
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=F32_SUM_RTOL)
    instrument.reset("kernels.")


def test_wrappers_reject_float16_and_int(cuda_device):
    from repro_torch.kernels.joint_prox import joint_prox_step
    from repro_torch.kernels.prox_l1 import prox_step
    from repro_torch.kernels.shard_prox import fused_prox_residual

    for dtype in (torch.float16, torch.int32):
        S = torch.eye(4, device=cuda_device).to(dtype)[None]
        lm = torch.ones(1, device=cuda_device).to(dtype)
        with pytest.raises(TypeError, match="float64 or float32"):
            glasso_forest_stack(S, lm)
        with pytest.raises(TypeError, match="float64 or float32"):
            fused_bcd_stack(S, lm, lm, S, S)
        with pytest.raises(TypeError, match="float64 or float32"):
            prox_step(S, S, 0.5, 0.5)
        with pytest.raises(TypeError, match="float64 or float32"):
            fused_prox_residual(S, S, S, 0.5)
        ops = [torch.zeros((2, 3, 4, 4), device=cuda_device).to(dtype) for _ in range(3)]
        with pytest.raises(TypeError, match="float64 or float32"):
            joint_prox_step(*ops, torch.zeros((2, 2), device=cuda_device).to(dtype),
                            penalty="group")
    S64 = torch.eye(4, device=cuda_device, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="per-block"):
        glasso_forest_stack(S64, torch.ones(2, device=cuda_device, dtype=torch.float64))
    lm = torch.ones(1, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="must match"):
        fused_bcd_stack(S64, lm, lm, S64[:, :2, :2], S64)
    with pytest.raises(TypeError, match="must match blocks"):
        fused_bcd_stack(S64, lm, lm, S64.float(), S64)


def test_glasso_on_the_card_matches_the_cpu_path(cuda_device):
    """The whole dense solve on the card goes through both kernels and agrees
    with the plain-PyTorch CPU path: same labels and route mix."""
    from repro_torch.covariance import structured_synthetic

    S = structured_synthetic(20, 12, seed=0)
    lam = 0.6
    want = repro_torch.glasso(S, lam, options=repro_torch.EngineOptions(device="cpu"))
    # the data must hold blocks for both kernels: trees and general blocks
    assert want.route_mix.get("tree", 0) > 0 and want.route_mix.get("general", 0) > 0
    instrument.reset("kernels.")
    got = repro_torch.glasso(S, lam)
    assert instrument.count("kernels.tree_glasso.launches") > 0
    assert instrument.count("kernels.bucket_glasso.launches") > 0
    assert got.device.startswith("cuda")
    assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-9)


# ---------------------------------------------------------------- slice 2
# threshold_cc compares in S's own dtype exactly as the plain step does, so
# its labels are equal, not close.  covgram_screen sums the same products in
# another order: bit-equal on integer data with a power-of-two n (every
# partial sum is exact), within 1e-12 of max|S| on Gaussian data (float64
# sums of <= 96 terms).


@pytest.mark.parametrize("p", [1, 7, 33, 200, 1000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_threshold_cc_step_matches_plain(cuda_device, p, dtype):
    from repro_torch.kernels.threshold_cc import labelprop_step, labelprop_step_ref

    rng = np.random.default_rng(p)
    A = rng.uniform(-1.0, 1.0, size=(p, p))
    S = 0.5 * (A + A.T)
    lam = 0.9
    if p > 2:  # an exact tie: not an edge
        S[0, 1] = S[1, 0] = lam
    St = torch.as_tensor(S, dtype=dtype, device=cuda_device)
    labels = torch.as_tensor(rng.permutation(p), dtype=torch.int32, device=cuda_device)
    instrument.reset("kernels.")
    got = labelprop_step(St, labels, lam)
    want = labelprop_step_ref(St, labels, lam)
    torch.cuda.synchronize()
    assert instrument.count("kernels.threshold_cc.launches") == 1
    assert torch.equal(got, want)


def test_pallas_backend_on_the_card_equals_host(cuda_device):
    """The device screen through the registry, near tie included: the
    float64 kernel keeps an edge that exceeds lam by 1e-12."""
    from repro_torch.core.screening import thresholded_components
    from repro_torch.covariance import structured_synthetic

    S = structured_synthetic(30, 12, seed=1)
    want, _ = thresholded_components(S, 0.6)
    instrument.reset("kernels.")
    got, _ = thresholded_components(S, 0.6, backend="pallas", device="cuda")
    assert instrument.count("kernels.threshold_cc.launches") > 0
    assert np.array_equal(got, want)
    T = np.eye(4)
    T[0, 1] = T[1, 0] = 0.5 + 1e-12
    got, _ = thresholded_components(T, 0.5, backend="pallas", device="cuda")
    assert got.tolist() == [0, 0, 2, 3]


def _screen_inputs(X, tile, chunk=64):
    from repro_torch.kernels.covgram_screen import pad_for_screen

    n, p = X.shape
    mu = X.mean(axis=0)
    x = torch.as_tensor(X, device="cuda")
    x_pad, mu_pad = pad_for_screen(x, mu, block_n=chunk, block_p=tile)
    nt = x_pad.shape[1] // tile
    ti, tj = np.triu_indices(nt)
    return x_pad, mu_pad, ti.astype(np.int32), tj.astype(np.int32)


def _device_events(fn):
    """The profiler's device events of ``fn()`` by name, each with its
    count a call."""
    return profile_calls(fn, 10)[0]


# covgram_screen runs on the FP64 tensor cores in k-steps of its mma shape:
# Gaussian data agrees with the plain version within 1e-12 of max|S| with
# equal counts; integer data (every value exact) bit for bit.  chunk 67
# pads n = 64 and n = 100 to N = 67 and N = 134 (with rows of mu), not
# multiples of the k-step (8) nor of the kernel's 16-row stages; tile 33
# takes the 8-byte copy path.
@pytest.mark.parametrize("tile", [33, 48, 64, 100, 128, 512, 2048])
@pytest.mark.parametrize("integer", [True, False])
def test_covgram_screen_matches_plain(cuda_device, tile, integer):
    from repro_torch.kernels.covgram_screen import covgram_screen_ref, covgram_screen_tiles

    rng = np.random.default_rng(tile)
    n, p = (64, 300) if integer else (100, 300)
    if integer:
        X = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    else:
        X = rng.standard_normal((n, p)) * (0.1 + rng.random(p))
    x_pad, mu_pad, ti, tj = _screen_inputs(X, tile, chunk=67)
    assert x_pad.shape[0] % 4
    vals = np.unique(np.abs(np.cov(X, rowvar=False, bias=True))[np.triu_indices(p, 1)])
    k = int(0.9 * vals.size)
    # integer data: lam an existing |S_ij| (an exact tie, not an edge);
    # Gaussian data: lam midway between two values, far from any entry
    lam = float(vals[k]) if integer else float(0.5 * (vals[k] + vals[k + 1]))
    instrument.reset("kernels.")
    got = covgram_screen_tiles(x_pad, mu_pad, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    want = covgram_screen_ref(x_pad, mu_pad, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    torch.cuda.synchronize()
    assert instrument.count("kernels.covgram_screen.launches") == 1
    if integer:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        scale = float(want[2][:, 0].max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-12 * scale
        assert float((got[2] - want[2]).abs().max()) <= 1e-12 * scale
        assert torch.equal(got[1], want[1])


def test_covgram_screen_call_is_one_device_event(cuda_device):
    """With the tile indices on the card, as the screening paths pass them,
    a call is the kernel's one launch: no fill of counts or stats, no copy;
    the cached accumulators are left zeroed, so a second batch of another
    size agrees too."""
    from repro_torch.kernels.covgram_screen import covgram_screen_ref, covgram_screen_tiles
    from repro_torch.kernels.covgram_screen.ops import _ACC

    rng = np.random.default_rng(11)
    n, p, tile = 90, 700, 128
    X = rng.standard_normal((n, p))
    x_pad, mu_pad, ti, tj = _screen_inputs(X, tile)
    kw = dict(n_true=n, p_true=p, block_p=tile)
    for b0, b1 in ((0, len(ti)), (3, 9)):
        i_dev = torch.as_tensor(ti[b0:b1], device=cuda_device)
        j_dev = torch.as_tensor(tj[b0:b1], device=cuda_device)
        events = _device_events(lambda: covgram_screen_tiles(x_pad, mu_pad, i_dev, j_dev, 0.1,
                                                             **kw))
        assert len(events) == 1, events
        name, per_call = next(iter(events.items()))
        assert "covgram_screen" in name and 0.0 < per_call <= 1.0, events
        got = covgram_screen_tiles(x_pad, mu_pad, i_dev, j_dev, 0.1, **kw)
        want = covgram_screen_ref(x_pad, mu_pad, ti[b0:b1], tj[b0:b1], 0.1, **kw)
        torch.cuda.synchronize()
        scale = float(want[2][:, 0].max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-12 * scale
        assert float((got[2] - want[2]).abs().max()) <= 1e-12 * scale
        assert torch.equal(got[1], want[1])
        assert int(_ACC[x_pad.device].abs().sum()) == 0


def test_covgram_screen_rejects_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels.covgram_screen import covgram_screen_tiles

    x = torch.zeros((8, 16), dtype=torch.float32, device=cuda_device)
    mu = torch.zeros(16, dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError, match="float64"):
        covgram_screen_tiles(x, mu, [0], [0], 0.1, n_true=8, p_true=16, block_p=16)
    with pytest.raises(ValueError, match="multiple of block_p"):
        covgram_screen_tiles(x.double(), mu.double(), [0], [0], 0.1, n_true=8,
                             p_true=16, block_p=12)


def _grouped_data():
    rng = np.random.default_rng(0)
    n, p = 128, 200
    X = rng.standard_normal((n, p)) * (0.05 + 0.2 * rng.random(p))
    f = rng.standard_normal((n, 12))
    for g in range(12):  # planted groups: trees, cycles and denser blocks
        cols = slice(g * 6, g * 6 + 6)
        X[:, cols] = 0.7 * f[:, [g]] + 0.7 * rng.standard_normal((n, 6))
    return X


def test_glasso_from_data_on_the_card_matches_the_cpu_path(cuda_device):
    """glasso(X=...) on the card streams through covgram_screen, solves
    through both solve kernels, and agrees with the CPU path."""
    X = _grouped_data()
    lam = 0.45
    stream = {"tile": 64, "chunk": 32}
    cpu = repro_torch.EngineOptions(device="cpu", output="dense")
    want = repro_torch.glasso(X=X, lam=lam, stream=stream, options=cpu)
    # the data must hold blocks for both solve kernels: trees and general
    assert want.route_mix.get("tree", 0) > 0 and want.route_mix.get("general", 0) > 0
    instrument.reset("kernels.")
    got = repro_torch.glasso(X=X, lam=lam, stream=stream,
                             options=repro_torch.EngineOptions(output="dense"))
    assert instrument.count("kernels.covgram_screen.launches") > 0
    assert instrument.count("kernels.tree_glasso.launches") > 0
    assert instrument.count("kernels.bucket_glasso.launches") > 0
    assert got.device.startswith("cuda")
    assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-9)


def test_glasso_from_float32_data_on_the_card_matches_the_cpu_path(cuda_device):
    """float32 X is promoted to float64 before the float64 covgram_screen
    kernel, on the card as on the CPU, so both paths take it and agree."""
    X = _grouped_data().astype(np.float32)
    lam = 0.45
    stream = {"tile": 64, "chunk": 32}
    cpu = repro_torch.EngineOptions(device="cpu", output="dense")
    want = repro_torch.glasso(X=X, lam=lam, stream=stream, options=cpu)
    assert want.route_mix.get("general", 0) > 0
    instrument.reset("kernels.")
    got = repro_torch.glasso(X=X, lam=lam, stream=stream,
                             options=repro_torch.EngineOptions(output="dense"))
    assert instrument.count("kernels.covgram_screen.launches") > 0
    assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-9)


# ---------------------------------------------------------------- slice 3
# joint_prox repeats the plain version's arithmetic operation for operation
# (rounded products, the same order per entry); only the K-class and
# per-lane residual sums run in another order: atol 1e-12 on Z and U,
# rtol 1e-9 on rp2 and rd2, as in tests/test_torch_joint_prox.py.


@pytest.mark.parametrize("penalty", ["group", "fused"])
@pytest.mark.parametrize("K,b", [(1, 7), (3, 17), (4, 16), (16, 5)])
def test_joint_prox_matches_plain(cuda_device, K, b, penalty):
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step

    rng = np.random.default_rng(100 * K + b)
    n = 5
    theta, u, z_old = (
        torch.as_tensor(rng.standard_normal((n, K, b, b)), device=cuda_device)
        for _ in range(3)
    )
    if K > 1:  # tied class values at some entries
        theta[:, 1, :2] = theta[:, 0, :2]
        u[:, 1, :2] = u[:, 0, :2]
    t = torch.as_tensor(
        np.stack([0.3 * rng.random(n) + 0.01, 0.3 * rng.random(n)], axis=1), device=cuda_device
    )
    instrument.reset("kernels.")
    got = joint_prox_step(theta, u, z_old, t, penalty=penalty)
    want = joint_prox_ref(theta, u, z_old, t, penalty=penalty)
    torch.cuda.synchronize()
    assert instrument.count("kernels.joint_prox.launches") == 1
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-12
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-9)
    if K > 1:
        assert torch.equal(got[0][:, 1, :2], got[0][:, 0, :2])


def test_joint_prox_rejects_what_the_kernel_does_not_take(cuda_device):
    """Any K and float64 or float32 run; float16, int and mixed dtypes raise."""
    from repro_torch.kernels.joint_prox import joint_prox_step

    ops = [torch.zeros((2, 17, 4, 4), dtype=torch.float64, device=cuda_device) for _ in range(3)]
    t = torch.zeros((2, 2), dtype=torch.float64, device=cuda_device)
    z, _, rp2, _ = joint_prox_step(*ops, t, penalty="group")
    assert z.shape == ops[0].shape and float(rp2.abs().max()) == 0.0
    with pytest.raises(TypeError, match="float64 or float32"):
        joint_prox_step(*(x.half() for x in ops), t.half(), penalty="fused")
    with pytest.raises(TypeError, match="share one dtype"):
        joint_prox_step(*ops, t.float(), penalty="fused")


@pytest.mark.parametrize("penalty", ["group", "fused"])
@pytest.mark.parametrize("K,b", [(17, 5), (20, 16), (40, 3), (130, 3)])
def test_joint_prox_shared_memory_shape_matches_plain(cuda_device, K, b, penalty):
    """K above 16 takes the shared-memory shape (K = 130: its work arrays in
    device scratch): the plain version's arithmetic with the register
    shape's tolerances, ties included."""
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step

    rng = np.random.default_rng(7 * K + b)
    n = 3
    theta, u, z_old = (
        torch.as_tensor(rng.standard_normal((n, K, b, b)), device=cuda_device)
        for _ in range(3)
    )
    theta[:, 1, :2] = theta[:, 0, :2]
    u[:, 1, :2] = u[:, 0, :2]
    t = torch.as_tensor(
        np.stack([0.3 * rng.random(n) + 0.01, 0.3 * rng.random(n)], axis=1), device=cuda_device
    )
    instrument.reset("kernels.")
    got = joint_prox_step(theta, u, z_old, t, penalty=penalty)
    want = joint_prox_ref(theta, u, z_old, t, penalty=penalty)
    torch.cuda.synchronize()
    assert instrument.count("kernels.joint_prox.launches") == 1
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-12
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-9)
    assert torch.equal(got[0][:, 1, :2], got[0][:, 0, :2])


def _joint_lanes(rng, n, K, b, device, dtype=torch.float64, dyadic=False):
    """theta, u, z_old (n, K, b, b) and t (n, 2); ``dyadic``: every value a
    small multiple of 1/16 and t multiples of 1/64, so the plain version
    and the kernel compute every step exactly or with one rounding each."""
    if dyadic:
        ops = [rng.integers(-32, 33, size=(n, K, b, b)) / 16.0 for _ in range(3)]
        t = rng.integers(1, 17, size=(n, 2)) / 64.0
    else:
        ops = [rng.standard_normal((n, K, b, b)) for _ in range(3)]
        t = np.stack([0.3 * rng.random(n) + 0.01, 0.3 * rng.random(n)], axis=1)
    return [torch.as_tensor(x, device=device).to(dtype) for x in (*ops, t)]


# joint_prox is one launch a call: each block writes its partials and takes
# a ticket; the lane's last block sums the partials in block order and
# resets the lane's counter in the cached scratch
@pytest.mark.parametrize("K,b", [(4, 40), (20, 16), (130, 3)])
def test_joint_prox_call_is_one_device_event(cuda_device, K, b):
    """The register shape, the shared-memory shape and its device-scratch
    case (K = 130) each run as one device event a call and nothing else."""
    from repro_torch.kernels.joint_prox import joint_prox_step

    ops = _joint_lanes(np.random.default_rng(K), 3, K, b, cuda_device)
    for penalty in ("group", "fused"):
        events = _device_events(lambda: joint_prox_step(*ops, penalty=penalty))
        assert len(events) == 1, events
        name, per_call = next(iter(events.items()))
        assert "joint_prox" in name and 0.0 < per_call <= 1.0, events


@pytest.mark.parametrize("K,b", [(4, 100), (16, 33), (20, 40), (130, 5)])
def test_joint_prox_sums_are_bit_identical_from_call_to_call(cuda_device, K, b):
    from repro_torch.kernels.joint_prox import joint_prox_step

    ops = _joint_lanes(np.random.default_rng(K + b), 6, K, b, cuda_device)
    for penalty in ("group", "fused"):
        first = joint_prox_step(*ops, penalty=penalty)
        for _ in range(3):
            again = joint_prox_step(*ops, penalty=penalty)
            torch.cuda.synchronize()
            for g, w in zip(first, again):
                assert torch.equal(g, w)


def test_joint_prox_scratch_is_reused_across_shapes(cuda_device):
    """Calls of changing (n, K, b), in both shapes and both dtypes, share
    the cached scratch: each matches the plain version and leaves every lane
    counter at zero."""
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step
    from repro_torch.kernels.joint_prox.ops import _SCRATCH

    rng = np.random.default_rng(91)
    for dtype in (torch.float64, torch.float32):
        for n, K, b in [(5, 4, 16), (2, 20, 30), (9, 3, 7), (1, 130, 4), (12, 16, 20),
                        (3, 250, 3), (5, 4, 16)]:
            ops = _joint_lanes(rng, n, K, b, cuda_device, dtype)
            for penalty in ("group", "fused"):
                got = joint_prox_step(*ops, penalty=penalty)
                want = joint_prox_ref(*ops, penalty=penalty)
                torch.cuda.synchronize()
                atol, rtol = (1e-12, 1e-9) if dtype == torch.float64 else (1e-5, F32_SUM_RTOL)
                for g, w in zip(got[:2], want[:2]):
                    assert float((g - w).abs().max()) <= atol
                for g, w in zip(got[2:], want[2:]):
                    assert g.shape == w.shape == (n,)
                    np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol)
                _, tickets = _SCRATCH[(ops[0].device, dtype)]
                assert int(tickets.abs().sum()) == 0


@pytest.mark.parametrize("K,b", [(1, 9), (4, 17), (16, 8), (20, 9), (130, 3)])
def test_joint_prox_is_bit_equal_on_representable_data(cuda_device, K, b):
    """On dyadic data the kernel's per-entry arithmetic is the plain
    version's operation for operation: Z and U equal bit for bit, in every
    shape, ties included."""
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step

    ops = _joint_lanes(np.random.default_rng(3 * K + b), 4, K, b, cuda_device, dyadic=True)
    for penalty in ("group", "fused"):
        got = joint_prox_step(*ops, penalty=penalty)
        want = joint_prox_ref(*ops, penalty=penalty)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-9)


def test_joint_glasso_on_the_card_matches_the_cpu_path(cuda_device):
    """joint_glasso on the card goes through joint_prox (joint_general),
    tree_glasso (joint_forest) and bucket_glasso (joint_shared), and agrees
    with the plain-PyTorch CPU path: same labels, route mix and fallbacks."""
    from repro_torch.covariance import structured_synthetic
    from repro_torch.joint import joint_glasso

    Ss = list(structured_synthetic(40, 12, classes=3, shared_fraction=0.8, seed=1))
    opts = dict(output="dense", solver_opts={"tol": 1e-9})
    want = joint_glasso(Ss, 0.4, 0.1, options=repro_torch.EngineOptions(device="cpu", **opts))
    # the data must hold blocks for all three kernels
    for cls in ("joint_general", "joint_forest", "joint_shared"):
        assert want.route_mix.get(cls, 0) > 0, want.route_mix
    instrument.reset("kernels.")
    got = joint_glasso(Ss, 0.4, 0.1, options=repro_torch.EngineOptions(**opts))
    for name in ("joint_prox", "tree_glasso", "bucket_glasso"):
        assert instrument.count(f"kernels.{name}.launches") > 0, name
    assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
    assert got.fallbacks == want.fallbacks == 0
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-7)


@pytest.mark.parametrize("B,b", [(1, 1), (3, 7), (5, 33), (2, 256)])
def test_prox_l1_matches_plain(cuda_device, B, b):
    """Bit-equal to the plain version for every form of t and lam: a Python
    scalar, a 0-d tensor on the card and on the CPU, a per-lane (B,) tensor
    and a strided view of one; odd sizes included; ties
    |theta - t*grad| == t*lam give exactly 0.  A call is one launch and one
    device event; a t of the wrong shape raises."""
    from repro_torch.kernels.prox_l1 import prox_step, prox_step_ref

    rng = np.random.default_rng(10 * B + b)
    theta, grad = (torch.as_tensor(rng.standard_normal((B, b, b)), device=cuda_device)
                   for _ in range(2))
    t, lam = 0.5, 0.75
    theta[:, 0, 0] = 0.375   # a tie: |theta - t*0| == t*lam
    grad[:, 0, 0] = 0.0
    t_lane = torch.as_tensor(rng.uniform(0.05, 1.5, B), device=cuda_device)
    lam_lane = torch.as_tensor(rng.uniform(0.0, 1.0, B), device=cuda_device)
    t_strided = torch.as_tensor(rng.uniform(0.05, 1.5, 2 * B), device=cuda_device)[::2]
    forms = [(t, lam), (t_lane, lam_lane), (t_strided, lam),
             (torch.tensor(t, dtype=torch.float64, device=cuda_device), lam_lane),
             (torch.tensor(t, dtype=torch.float64), torch.tensor(lam, dtype=torch.float64))]
    instrument.reset("kernels.")
    got = [prox_step(theta, grad, tt, ll) for tt, ll in forms]
    torch.cuda.synchronize()
    assert instrument.count("kernels.prox_l1.launches") == len(forms)
    for out, (tt, ll) in zip(got, forms):
        assert torch.equal(out, prox_step_ref(theta, grad, tt, ll))
    assert (got[0][:, 0, 0] == 0).all()
    assert torch.equal(prox_step(theta[0], grad[0], t, lam), got[0][0])
    for tt, ll in forms:
        events = _device_events(lambda: prox_step(theta, grad, tt, ll))
        assert len(events) == 1, events
        name, per_call = next(iter(events.items()))
        assert "prox_l1" in name and 0.0 < per_call <= 1.0, events
    with pytest.raises(ValueError, match="t must be"):
        prox_step(theta, grad, t_lane[: B - 1] if B > 1 else t_lane.repeat(2), lam)


@pytest.mark.parametrize("shape", [(8, 136), (1, 1), (3, 17, 17), (2, 300, 257)])
def test_shard_prox_matches_plain(cuda_device, shape):
    """Z' and U' bit-equal to the plain version, rp2/rd2 within 1e-14
    relative (the same squares summed in another order) and identical from
    run to run (fixed-order partial sums, no atomics)."""
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

    rng = np.random.default_rng(sum(shape))
    x, u, z = (torch.as_tensor(rng.standard_normal(shape), device=cuda_device)
               for _ in range(3))
    t = (torch.as_tensor(rng.uniform(0.05, 1.0, shape[0]), device=cuda_device)
         if len(shape) == 3 else 0.3)
    instrument.reset("kernels.")
    got = fused_prox_residual(x, u, z, t)
    again = fused_prox_residual(x, u, z, t)
    torch.cuda.synchronize()
    assert instrument.count("kernels.shard_prox.launches") == 2
    want = fused_prox_ref(x, u, z, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-14)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# shard_prox is one launch a call: each block writes its partials and takes
# a ticket; the lane's last block sums the partials in a fixed order and
# resets the lane's counter in the cached scratch
@pytest.mark.parametrize("shape", [(1280, 1280), (7, 300, 300)])
def test_shard_prox_sums_are_bit_identical_from_call_to_call(cuda_device, shape):
    from repro_torch.kernels.shard_prox import fused_prox_residual

    rng = np.random.default_rng(len(shape))
    x, u, z = (torch.as_tensor(rng.standard_normal(shape), device=cuda_device)
               for _ in range(3))
    t = (torch.as_tensor(rng.uniform(0.05, 1.0, shape[0]), device=cuda_device)
         if len(shape) == 3 else torch.tensor(0.3, dtype=torch.float64, device=cuda_device))
    first = fused_prox_residual(x, u, z, t)
    for _ in range(3):
        again = fused_prox_residual(x, u, z, t)
        torch.cuda.synchronize()
        assert torch.equal(first[2], again[2]) and torch.equal(first[3], again[3])


def test_shard_prox_scratch_is_reused_across_lane_counts_and_sizes(cuda_device):
    """Calls of different lane counts and sizes one after another share the
    cached scratch: every call matches the plain version and leaves every
    lane counter at zero."""
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual
    from repro_torch.kernels.shard_prox.ops import _SCRATCH

    rng = np.random.default_rng(77)
    for dtype in (torch.float64, torch.float32):
        for shape in [(5, 64, 64), (2, 300, 300), (9, 17, 17), (600, 600), (12, 40, 40),
                      (5, 64, 64)]:
            x, u, z = (torch.as_tensor(rng.standard_normal(shape), device=cuda_device)
                       .to(dtype) for _ in range(3))
            t = (torch.as_tensor(rng.uniform(0.05, 1.0, shape[0]), device=cuda_device)
                 .to(dtype) if len(shape) == 3 else 0.4)
            got, want = fused_prox_residual(x, u, z, t), fused_prox_ref(x, u, z, t)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            rtol = 1e-14 if dtype == torch.float64 else F32_SUM_RTOL
            for g, w in zip(got[2:], want[2:]):
                assert g.shape == w.shape
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol)
            _, tickets = _SCRATCH[(x.device, dtype)]
            assert int(tickets.abs().sum()) == 0


def test_shard_prox_threshold_forms_agree(cuda_device):
    """A 0-d tensor t, a Python scalar t and an (N,) t (contiguous, and a
    strided view) give the same Z', U', rp2 and rd2 as the plain version."""
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

    rng = np.random.default_rng(78)
    x, u, z = (torch.as_tensor(rng.standard_normal((4, 130, 130)), device=cuda_device)
               for _ in range(3))
    value = 0.35
    lanes = torch.full((4,), value, dtype=torch.float64, device=cuda_device)
    strided = torch.full((4, 2), value, dtype=torch.float64, device=cuda_device)[:, 0]
    forms = [torch.tensor(value, dtype=torch.float64, device=cuda_device), value, lanes, strided]
    want = fused_prox_ref(x, u, z, value)
    outs = [fused_prox_residual(x, u, z, t) for t in forms]
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-14)
        assert torch.equal(got[2], outs[0][2]) and torch.equal(got[3], outs[0][3])
    single = [fused_prox_residual(x[0], u[0], z[0], t)
              for t in (forms[0], value, lanes[:1])]
    want = fused_prox_ref(x[0], u[0], z[0], value)
    for got in single:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2].shape == () and torch.equal(got[2], single[0][2])
        np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-14)
    with pytest.raises(ValueError, match="t must be"):
        fused_prox_residual(x, u, z, lanes[:3])


def _solver_lanes(rng, n, b):
    blocks, lams = [], []
    for _ in range(n):
        S = _covariance(rng, b - 1)
        blocks.append(pad_block(S, b))
        lams.append(_lam(S, 0.5))
    return np.stack(blocks), np.asarray(lams)


def test_pg_and_admm_buckets_on_the_card_match_the_cpu(cuda_device):
    """The batched pg (prox_l1) and admm (shard_prox) solves on the card
    against the same solves on the CPU, lane by lane: Theta within 1e-6
    (pg: its line search's accept test can flip on last-bit differences of
    cuSOLVER's and LAPACK's Cholesky) and 1e-8 (admm, tol 1e-9), admm's
    iteration counts equal."""
    from repro_torch.core.solvers import glasso_admm_info, glasso_pg_stack

    rng = np.random.default_rng(5)
    blocks, lams = _solver_lanes(rng, 6, 12)
    S_c, l_c = torch.as_tensor(blocks), torch.as_tensor(lams)
    S_g, l_g = S_c.to(cuda_device), l_c.to(cuda_device)
    instrument.reset("kernels.")
    pg = glasso_pg_stack(S_g, l_g)
    admm, it = glasso_admm_info(S_g, l_g, tol=1e-9)
    torch.cuda.synchronize()
    assert instrument.count("kernels.prox_l1.launches") > 0
    assert instrument.count("kernels.shard_prox.launches") > 0
    np.testing.assert_allclose(pg.cpu().numpy(), glasso_pg_stack(S_c, l_c).numpy(),
                               rtol=0, atol=1e-6)
    admm_c, it_c = glasso_admm_info(S_c, l_c, tol=1e-9)
    np.testing.assert_allclose(admm.cpu().numpy(), admm_c.numpy(), rtol=0, atol=1e-8)
    assert it.cpu().tolist() == it_c.tolist()


def test_glasso_sharded_on_the_card_matches_the_cpu(cuda_device):
    """The sharded solve through shard_prox on the card: the same outer
    iterations as on the CPU, Theta within 1e-8, KKT verified in place."""
    from repro_torch.core.solvers import glasso_sharded

    rng = np.random.default_rng(6)
    S = _covariance(rng, 40)
    lam = _lam(S, 0.5)
    instrument.reset("kernels.")
    got = glasso_sharded(S, lam)
    assert instrument.count("kernels.shard_prox.launches") == got.iters > 0
    want = glasso_sharded(S, lam, device="cpu")
    assert got.iters == want.iters and got.retries == want.retries
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-8)
    assert got.kkt_residual <= 1e-6 * max(1.0, got.s_max)


def test_glasso_oversize_and_solvers_on_the_card_match_the_cpu(cuda_device):
    """glasso(S, lam) on the card with solver pg and admm, and with the
    oversize route, against the CPU path: labels, route mix, oversize
    accounting."""
    rng = np.random.default_rng(7)
    S = _covariance(rng, 30)
    lam = _lam(S, 0.4)
    for opts in (dict(solver="pg"), dict(solver="admm", solver_opts={"tol": 1e-9}),
                 dict(solver="admm", solver_opts={"tol": 1e-9}, oversize_threshold=10)):
        want = repro_torch.glasso(S, lam, options=repro_torch.EngineOptions(device="cpu", **opts))
        instrument.reset("kernels.")
        got = repro_torch.glasso(S, lam, options=repro_torch.EngineOptions(**opts))
        name = "prox_l1" if opts["solver"] == "pg" else "shard_prox"
        assert instrument.count(f"kernels.{name}.launches") > 0, opts
        assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
        assert got.oversize == want.oversize
        np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-6)


def test_glasso_from_data_oversize_on_the_card_matches_the_cpu(cuda_device):
    """glasso(X=..., oversize_threshold=...) on the card: the giant
    component is deferred to its centered columns on the card, gathered
    onto the card and solved on the sharded route through shard_prox, as
    on the CPU path (same labels, route mix and oversize accounting)."""
    rng = np.random.default_rng(8)
    n, p, k = 64, 48, 30
    X = 0.3 * rng.standard_normal((n, p))
    X[:, :k] += rng.standard_normal((n, 1)) * (0.8 + 0.2 * rng.random(k))
    opts = dict(solver="admm", oversize_threshold=20, solver_opts={"tol": 1e-9},
                output="dense")
    want = repro_torch.glasso(X=X, lam=0.1, options=repro_torch.EngineOptions(
        device="cpu", **opts))
    assert want.route_mix.get("oversize", 0) >= 1
    instrument.reset("kernels.")
    instrument.reset("stream.")
    got = repro_torch.glasso(X=X, lam=0.1, options=repro_torch.EngineOptions(**opts))
    assert instrument.count("kernels.covgram_screen.launches") > 0
    assert instrument.count("kernels.shard_prox.launches") > 0
    assert instrument.count("stream.deferred_components") >= 1
    assert np.array_equal(got.labels, want.labels) and got.route_mix == want.route_mix
    assert got.oversize == want.oversize and got.oversize["fallbacks"] == 0
    np.testing.assert_allclose(got.Theta, want.Theta, rtol=0, atol=1e-8)


# ---------------------------------------------------------------- slice 5
# covgram sums n float32 products in another order than the plain version's
# float32 matrix product: each entry within n float32 epsilons of max|S|
# (the first-order bound on both sums' rounding).  bf16 X is upcast exactly
# by both.


# The kernel's edges: p a multiple of its 128-wide tile (256) and above it
# (260, clipped by the TMA stores; 257 takes the plain-store epilogue, as
# does every p = 1, 2, 3 mod 4); p below one 32-column store box (4, 8);
# n = 1; n past one 32-row chunk and not a multiple of it (300); p = 2100,
# 153 tiles, more than the persistent grid's one block an SM (132 on the
# H100), so a block takes several.
@pytest.mark.parametrize("n,p,dtype", [
    (80, 300, torch.float32), (37, 129, torch.float32), (64, 65, torch.bfloat16),
    (200, 64, torch.float64), (1, 5, torch.float32),
    (80, 256, torch.float32), (80, 260, torch.float32), (33, 257, torch.float32),
    (20, 258, torch.bfloat16), (50, 131, torch.float32), (7, 4, torch.float32),
    (5, 8, torch.bfloat16), (1, 128, torch.float32), (300, 136, torch.bfloat16),
    (16, 2100, torch.float32), (9, 2101, torch.bfloat16),
])
def test_covgram_matches_plain(cuda_device, n, p, dtype):
    from repro_torch.kernels.covgram import covgram, covgram_ref

    rng = np.random.default_rng(n + p)
    X = torch.as_tensor(rng.standard_normal((n, p)) * (0.1 + rng.random(p)) + 3.0,
                        device=cuda_device).to(dtype)
    instrument.reset("kernels.")
    got = covgram(X)
    want = covgram_ref(X)
    torch.cuda.synchronize()
    assert instrument.count("kernels.covgram.launches") == 1
    assert got.dtype == torch.float32 and got.shape == (p, p)
    tol = max(n, 1) * float(torch.finfo(torch.float32).eps) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("p", [64, 130])
def test_covgram_takes_unaligned_x_and_is_one_launch(cuda_device, p):
    """X at an offset of one element (no 16-byte rows: the element-wise
    loads) agrees as well; a call is the kernel's one launch beside the
    float32 column mean's reduction."""
    from repro_torch.kernels.covgram import covgram, covgram_ref

    rng = np.random.default_rng(p)
    n = 45
    flat = torch.as_tensor(rng.standard_normal(n * p + 1) + 2.0, dtype=torch.float32,
                           device=cuda_device)
    X = flat[1:].view(n, p)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    instrument.reset("kernels.")
    got = covgram(X)
    want = covgram_ref(X)
    torch.cuda.synchronize()
    assert instrument.count("kernels.covgram.launches") == 1
    tol = n * float(torch.finfo(torch.float32).eps) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, got.T)
    assert torch.equal(got, covgram(X.clone()))  # the vector loads: the same bits
    events = _device_events(lambda: covgram(X))
    kernel = [v for k, v in events.items() if "covgram" in k]
    assert len(kernel) == 1 and 0.0 < kernel[0] <= 1.0 and len(events) <= 2, events


@pytest.mark.parametrize("n", [1, 2, 3, 7, 77, 80, 100, 192, 1000, 4097, 65537, 16777217,
                               2**31 - 1])
def test_covgram_division_is_the_ieee_division(cuda_device, n):
    """The kernel divides each sum by n through two correction steps from
    RN(1/n) (the IEEE division only outside 2^-60 <= |a| <= 2^100): over
    all 2^32 float bit patterns its quotient has the IEEE division's bits."""
    from repro_torch.kernels.build import check, library

    count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    check(library().covgram_division_mismatches(
        n, count.data_ptr(), torch.cuda.current_stream().cuda_stream), "covgram")
    torch.cuda.synchronize()
    assert int(count) == 0


def test_covgram_rejects_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels.covgram import covgram

    with pytest.raises(TypeError, match="floating"):
        covgram(torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match=r"\(n, p\)"):
        covgram(torch.zeros(4, device=cuda_device))


# flash_attention: the kernel sums the same float32 products as its plain
# version in another order and normalises at the end (an online softmax)
# instead of first: float32 within 2e-5 and bf16 within 3e-2, the
# reference's own tolerances for its kernel (tests/test_kernels.py); the
# bf16 output rounds once from float32 in both.  Every bf16 call runs the
# wgmma body, which also rounds p to bf16 before p v; a d off a body's
# instances (4, 8, 12, 16, 80 in float32; 4, 8, 12, 80, 96 in bf16) runs
# padded with zero columns to the next one.
_FLASH_SHAPES = [
    (1, 4, 4, 64, 64, 16),     # MHA square
    (2, 8, 2, 32, 32, 8),      # GQA 4:1
    (1, 4, 1, 40, 72, 16),     # MQA, ragged and cross lengths
    (2, 4, 2, 100, 100, 4),    # head_dim 4, ragged past one tile
    (1, 16, 2, 300, 300, 128), # the full width's heads, ragged
    (1, 2, 1, 129, 65, 64),    # Skv below Sq, a one-key last tile
    (2, 4, 2, 300, 237, 64),   # several key tiles, Skv ragged below Sq
    (1, 8, 1, 190, 450, 128),  # several key tiles, Skv ragged above Sq
    (2, 4, 2, 96, 160, 32),    # d = 32 (64-byte swizzle), ragged
    (1, 4, 2, 70, 90, 12),     # d = 12, padded to 32 (float32) and 16 (bf16)
    (1, 8, 2, 130, 130, 80),   # phi-2's d = 80, padded to 96 (float32) and 128
    (2, 4, 4, 100, 150, 96),   # Phi-3-mini's d = 96 (float32's own; bf16 pads)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", _FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda_device, B, Hq, Hkv, Sq, Skv, d, causal, dtype):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    rng = np.random.default_rng(B * 1000 + Sq + d)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), device=cuda_device).to(dtype)
               for s in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d)))
    instrument.reset("kernels.")
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert instrument.count("kernels.flash_attention.launches") == 1
    wgmma = dtype == torch.bfloat16
    assert instrument.count("kernels.flash_attention.wgmma_launches") == int(wgmma)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_unaligned_and_strided_views(cuda_device, dtype):
    """Views starting off a 16-byte boundary, and a non-contiguous q, run
    the kernel on aligned copies and agree with the plain version."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    rng = np.random.default_rng(5)
    shape_q, shape_kv = (1, 4, 70, 64), (1, 2, 90, 64)
    flat = torch.as_tensor(rng.standard_normal(int(np.prod(shape_kv)) + 1),
                           device=cuda_device).to(dtype)
    k = flat[1:].view(shape_kv)  # one element past an aligned start
    assert k.data_ptr() % 16 != 0
    v = torch.as_tensor(rng.standard_normal(shape_kv), device=cuda_device).to(dtype)
    q = torch.as_tensor(rng.standard_normal((1, 70, 4, 64)), device=cuda_device).to(dtype)
    q = q.transpose(1, 2)
    assert q.shape == shape_q and not q.is_contiguous()
    instrument.reset("kernels.")
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert instrument.count("kernels.flash_attention.launches") == 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros((1, 4, 8, 16), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head_dim 160"):
        z = torch.zeros((1, 4, 8, 160), device=cuda_device)
        flash_attention(z, z, z)
    with pytest.raises(AssertionError, match="multiple of Hkv"):
        flash_attention(q, q[:, :3], q[:, :3])


def test_prefill_launches_flash_once_a_layer(cuda_device):
    """Prefill on the card runs every layer's self-attention through the
    kernel, and its logits agree with the reference's dense path on the
    card; decode launches it never."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.specs import make_batch
    from repro_torch.models.zoo import build_model

    cfg = dataclasses.replace(get_arch("qwen2_5_3b").reduced(), dtype="float32")
    model = build_model(cfg, device=cuda_device)
    model.init(0)
    batch = make_batch(cfg, ShapeConfig("s", 70, 2, "prefill"), seed=1, device=cuda_device)
    instrument.reset("kernels.")
    logits, caches = model.prefill(batch, capacity=72)
    assert instrument.count("kernels.flash_attention.launches") == cfg.n_layers
    dense, _ = model.prefill(batch, use_flash=False)
    assert float((logits - dense).abs().max()) <= 1e-4 * float(dense.abs().max())
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    model.decode_step(tok, caches, 70)
    assert instrument.count("kernels.flash_attention.launches") == cfg.n_layers


def test_bf16_prefill_runs_the_wgmma_body(cuda_device):
    """A bf16 prefill (the configs' own dtype) sends every layer's
    self-attention to the wgmma body; its logits stay within 5e-2
    max|logits| of the dense path's: both round to bf16 after every
    layer, and differ only in the attention output's rounding (~1 bf16
    ulp, 2^-8 relative), which the residual stream carries."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.specs import make_batch
    from repro_torch.models.zoo import build_model

    cfg = get_arch("qwen2_5_3b").reduced()
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg, device=cuda_device)
    model.init(0)
    batch = make_batch(cfg, ShapeConfig("s", 200, 2, "prefill"), seed=1, device=cuda_device)
    instrument.reset("kernels.")
    logits, _ = model.prefill(batch)
    assert instrument.count("kernels.flash_attention.launches") == cfg.n_layers
    assert instrument.count("kernels.flash_attention.wgmma_launches") == cfg.n_layers
    dense, _ = model.prefill(batch, use_flash=False)
    assert torch.isfinite(logits.float()).all()
    scale = float(dense.float().abs().max())
    assert float((logits.float() - dense.float()).abs().max()) <= 5e-2 * scale
