"""The port's joint_prox module against the reference package.

The plain PyTorch version (``repro_torch.kernels.joint_prox.ref``) takes a
whole bucket of lanes — (n, K, b, b) stacks and t of shape (n, 2) — and
must equal, lane by lane, the JAX reference ``joint_prox_ref`` and the
Pallas kernel in interpret mode called with that lane's own t, on the same
numpy inputs.  Both sides compute the same float64 expressions; sums over
the K classes and over a lane may be taken in another order, so the
tolerances are those of tests/test_joint.py: atol 1e-12 on Z and U,
rtol 1e-9 on rp2 and rd2.  The CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.joint_prox import fused_prox as jax_fused_prox
from repro.kernels.joint_prox import joint_prox_pallas
from repro.kernels.joint_prox import joint_prox_ref as jax_joint_prox_ref
from repro.kernels.joint_prox import tv_complete_prox as jax_tv_prox
from repro_torch.core import instrument
from repro_torch.kernels.joint_prox import (
    PENALTIES,
    fused_prox,
    group_prox,
    joint_prox_ref,
    joint_prox_step,
    tv_complete_prox,
)

ATOL = 1e-12
RTOL = 1e-9


def _lanes(rng, n, K, b):
    theta, u, z_old = (rng.standard_normal((n, K, b, b)) for _ in range(3))
    t = np.stack([0.3 * rng.random(n) + 0.01, 0.3 * rng.random(n)], axis=1)
    return theta, u, z_old, t


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("K", [1, 2, 4])
def test_lane_batched_plain_matches_reference_per_lane(K, penalty):
    rng = np.random.default_rng(10 * K + len(penalty))
    n, b = 3, 16
    theta, u, z_old, t = _lanes(rng, n, K, b)
    zn, un, rp2, rd2 = joint_prox_ref(*_torch(theta, u, z_old, t), penalty=penalty)
    assert zn.shape == un.shape == (n, K, b, b) and rp2.shape == rd2.shape == (n,)
    for lane in range(n):
        args = [jnp.asarray(x[lane]) for x in (theta, u, z_old)]
        t1, t2 = t[lane]
        want = jax_joint_prox_ref(*args, t1, t2, penalty=penalty)
        pz, pu, acc = joint_prox_pallas(
            *args, jnp.asarray([[t1, t2]]), penalty=penalty, row_tile=8, interpret=True
        )
        for z_ref, u_ref, r2 in ((want[0], want[1], want[2:]), (pz, pu, acc[0])):
            np.testing.assert_allclose(zn[lane].numpy(), np.asarray(z_ref), rtol=0, atol=ATOL)
            np.testing.assert_allclose(un[lane].numpy(), np.asarray(u_ref), rtol=0, atol=ATOL)
            np.testing.assert_allclose(float(rp2[lane]), float(r2[0]), rtol=RTOL)
            np.testing.assert_allclose(float(rd2[lane]), float(r2[1]), rtol=RTOL)


@pytest.mark.parametrize("K", [2, 3, 4, 7])
def test_fused_ties_give_tied_outputs(K):
    """Equal class values at an entry must come out equal, in the port and
    in the reference (the prox of a permutation-symmetric function)."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((K, 6, 6))
    a[1] = a[0]          # a pair tie at every entry
    a[K - 1, :3] = a[0, :3]  # a triple tie on half the rows
    t1, t2 = 0.05, 0.2
    got = fused_prox(torch.as_tensor(a), t1, t2).numpy()
    want = np.asarray(jax_fused_prox(jnp.asarray(a), t1, t2))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.array_equal(got[1], got[0])
    assert np.array_equal(got[K - 1, :3], got[0, :3])
    tv = tv_complete_prox(torch.as_tensor(a), t2).numpy()
    np.testing.assert_allclose(tv, np.asarray(jax_tv_prox(jnp.asarray(a), t2)), atol=ATOL)
    assert np.array_equal(tv[1], tv[0])


def test_single_block_functions_match_reference():
    from repro.kernels.joint_prox import group_prox as jax_group_prox

    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 9, 9))
    a[:, 0, 0] = 0.0  # an all-zero class vector: the group norm's 0 branch
    np.testing.assert_allclose(
        group_prox(torch.as_tensor(a), 0.3, 0.4).numpy(),
        np.asarray(jax_group_prox(jnp.asarray(a), 0.3, 0.4)), rtol=0, atol=ATOL,
    )


def test_cpu_step_runs_the_plain_version_and_validates():
    """On the CPU the wrapper is the plain version and launches nothing;
    an unknown penalty raises on any device."""
    rng = np.random.default_rng(0)
    ops = _torch(*_lanes(rng, 2, 3, 5))
    instrument.reset("kernels.")
    got = joint_prox_step(*ops, penalty="fused")
    want = joint_prox_ref(*ops, penalty="fused")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert instrument.count("kernels.joint_prox.launches") == 0
    with pytest.raises(ValueError, match="unknown joint penalty"):
        joint_prox_step(*ops, penalty="lasso")


def _kernel_order_sums(theta, z_new, z_old, *, tile):
    """rp2 and rd2 in the card kernel's fixed order, in plain torch: per
    entry the K classes in order (each square rounded, then added), per
    block of ``tile`` entries a warp's shuffle tree (offsets 16, 8, 4, 2, 1)
    and its warps in order, per lane the blocks one by one in order."""
    n, K, b, _ = theta.shape
    bb = b * b
    tiles = -(-bb // tile)

    def reduce(d):
        e = torch.zeros((n, bb), dtype=d.dtype)
        for k in range(K):
            e = e + d[:, k] * d[:, k]
        w = torch.nn.functional.pad(e, (0, tiles * tile - bb)).reshape(n, tiles, tile // 32, 32)
        for off in (16, 8, 4, 2, 1):
            w = w[..., :off] + w[..., off : 2 * off]
        block = torch.zeros((n, tiles), dtype=d.dtype)
        for warp in range(tile // 32):
            block = block + w[:, :, warp, 0]
        total = torch.zeros(n, dtype=d.dtype)
        for t in range(tiles):
            total = total + block[:, t]
        return total

    flat = (n, K, bb)
    return (reduce((theta - z_new).reshape(flat)), reduce((z_new - z_old).reshape(flat)))


# the register shape sums blocks of 256 entries (K <= 16), the
# shared-memory shape blocks of 64 (K > 16)
@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("K,b,tile", [(1, 23, 256), (3, 40, 256), (17, 9, 64)])
def test_kernel_reduction_order_matches_reference(K, b, tile, penalty):
    rng = np.random.default_rng(K * b)
    n = 3
    theta, u, z_old, t = _lanes(rng, n, K, b)
    zn, _, _, _ = joint_prox_ref(*_torch(theta, u, z_old, t), penalty=penalty)
    rp2, rd2 = _kernel_order_sums(*_torch(theta), zn, *_torch(z_old), tile=tile)
    for lane in range(n):
        args = [jnp.asarray(x[lane]) for x in (theta, u, z_old)]
        want = jax_joint_prox_ref(*args, *t[lane], penalty=penalty)
        np.testing.assert_allclose(float(rp2[lane]), float(want[2]), rtol=1e-12)
        np.testing.assert_allclose(float(rd2[lane]), float(want[3]), rtol=1e-12)
