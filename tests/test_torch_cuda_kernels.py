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


@pytest.mark.parametrize("b", [2, 5, 8, 33, 64, 384])
def test_tree_glasso_matches_plain(cuda_device, b):
    rng = np.random.default_rng(20 + b)
    B = 37
    blocks = rng.standard_normal((B, b, b))
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    blocks += np.abs(blocks).sum(axis=2).max(axis=1)[:, None, None] * np.eye(b)
    lams = rng.uniform(0.1, 0.6, size=B)
    if b > 2:  # exact ties |S_ij| == lam are not edges
        blocks[:, 0, 1] = blocks[:, 1, 0] = lams
    S = torch.as_tensor(blocks, device=cuda_device)
    lm = torch.as_tensor(lams, device=cuda_device)
    instrument.reset("kernels.")
    got = glasso_forest_stack(S, lm)
    want = glasso_forest_ref(S, lm)
    torch.cuda.synchronize()
    assert instrument.count("kernels.tree_glasso.launches") == 1
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    if b > 2:
        assert (got[:, 0, 1] == 0).all()


@pytest.mark.parametrize("b,N", [(4, 40), (16, 20), (32, 12), (64, 6), (96, 2), (128, 3)])
def test_bucket_glasso_matches_plain(cuda_device, b, N):
    """Cold and warm lanes, identity-padded: sweeps and inner sweeps equal,
    padded cross terms exactly zero.  b <= 64 keeps the tiles in shared
    memory, b = 96 and 128 in device scratch (96: not a power of two)."""
    rng = np.random.default_rng(b)
    live = b - b // 4
    covs = [_covariance(rng, live) for _ in range(N)]
    lams = np.array([_lam(s, 0.6) for s in covs])
    S = torch.as_tensor(np.stack([pad_block(s, b) for s in covs]), device=cuda_device)
    lm = torch.as_tensor(lams, device=cuda_device)
    scales = convergence_scale(S)
    eye = torch.eye(b, dtype=torch.float64, device=cuda_device)
    W_cold, T_cold = S + lm[:, None, None] * eye, eye.expand(N, b, b).contiguous()
    T_warm, _ = fused_bcd_stack(S, 1.2 * lm, scales, W_cold, T_cold)
    for W0, T0 in ((W_cold, T_cold), (torch.linalg.inv(T_warm), T_warm)):
        cd = torch.zeros(N, dtype=torch.int64, device=cuda_device)
        cd_ref = torch.zeros_like(cd)
        got, sw = fused_bcd_stack(S, lm, scales, W0, T0, cd_sweeps=cd)
        want, sw_ref = fused_bcd_ref_stack(S, lm, scales, W0, T0, cd_sweeps=cd_ref)
        torch.cuda.synchronize()
        assert torch.equal(sw, sw_ref) and torch.equal(cd, cd_ref)
        assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())
        assert (got[:, live:, :live] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    S = torch.eye(4, device=cuda_device, dtype=torch.float32)[None]
    lm = torch.ones(1, device=cuda_device, dtype=torch.float32)
    with pytest.raises(TypeError, match="float64"):
        glasso_forest_stack(S, lm)
    S64 = S.double()
    with pytest.raises(ValueError, match="per-block"):
        glasso_forest_stack(S64, torch.ones(2, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError, match="must match"):
        fused_bcd_stack(S64, lm.double(), lm.double(), S64[:, :2, :2], S64)


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
