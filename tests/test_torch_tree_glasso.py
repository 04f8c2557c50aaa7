"""The port's tree_glasso module against the reference package.

The plain PyTorch version (``repro_torch.kernels.tree_glasso.ref``) is held
against the JAX reference ``glasso_forest_ref`` and against the Pallas
kernel in interpret mode, on the same numpy inputs.  Both sides compute the
same float64 expressions elementwise; only the row sum's order may differ,
so the tolerance is a few ulps of the result: atol 1e-12 on values of O(1).
The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_glasso.ref import glasso_forest_ref as jax_forest_ref
from repro.kernels.tree_glasso.tree_glasso import glasso_forest_pallas
from repro_torch.kernels.tree_glasso import glasso_forest_ref, glasso_forest_stack

ATOL = 1e-12


def _stack(rng, B, b, *, ties=False):
    """Diagonally dominant symmetric blocks and per-block lambdas; with
    ``ties`` some entries sit exactly at |S_ij| == lam (not edges)."""
    blocks = rng.standard_normal((B, b, b))
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    blocks += np.abs(blocks).sum(axis=2).max(axis=1)[:, None, None] * np.eye(b)
    lams = rng.uniform(0.1, 0.6, size=B)
    if ties and b > 2:
        blocks[:, 0, 1] = blocks[:, 1, 0] = lams
        blocks[:, 0, 2] = blocks[:, 2, 0] = -lams
    return blocks, lams


@pytest.mark.parametrize("b", [2, 5, 8, 33])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_matches_jax_reference(b, ties):
    rng = np.random.default_rng(b)
    blocks, lams = _stack(rng, 4, b, ties=ties)
    want = np.asarray(jax.vmap(jax_forest_ref)(jnp.asarray(blocks), jnp.asarray(lams)))
    got = glasso_forest_ref(torch.as_tensor(blocks), torch.as_tensor(lams)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if ties and b > 2:
        assert (got[:, 0, 1] == 0).all() and (got[:, 0, 2] == 0).all()


@pytest.mark.parametrize("B,b", [(3, 8), (2, 16)])
def test_plain_matches_pallas_interpret(B, b):
    rng = np.random.default_rng(10 + b)
    blocks, lams = _stack(rng, B, b)
    want = np.asarray(
        glasso_forest_pallas(
            jnp.asarray(blocks), jnp.asarray(lams)[:, None], interpret=True
        )
    )
    got = glasso_forest_ref(torch.as_tensor(blocks), torch.as_tensor(lams)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    blocks, lams = _stack(rng, 5, 6)
    S, lm = torch.as_tensor(blocks), torch.as_tensor(lams)
    assert torch.equal(glasso_forest_stack(S, lm), glasso_forest_ref(S, lm))


@pytest.mark.parametrize("form", ["per_block", "strided", "scalar", "tensor_0d"])
def test_wrapper_takes_every_lam_form(form):
    """The wrapper on the CPU takes lam as one value a block, a strided view
    of one, a Python scalar or a 0-d tensor, and matches the reference and
    its Pallas kernel in interpret mode for each."""
    rng = np.random.default_rng(7)
    B, b = 4, 8
    blocks, lams = _stack(rng, B, b, ties=True)
    if form in ("scalar", "tensor_0d"):
        lams = np.full(B, 0.35)
    lam = {
        "per_block": torch.as_tensor(lams),
        "strided": torch.as_tensor(np.repeat(lams, 3))[::3],
        "scalar": 0.35,
        "tensor_0d": torch.tensor(0.35, dtype=torch.float64),
    }[form]
    got = glasso_forest_stack(torch.as_tensor(blocks), lam).numpy()
    want = np.asarray(jax.vmap(jax_forest_ref)(jnp.asarray(blocks), jnp.asarray(lams)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want = np.asarray(
        glasso_forest_pallas(jnp.asarray(blocks), jnp.asarray(lams)[:, None], interpret=True)
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
