"""The port's covgram_screen module against the reference package.

The plain PyTorch version (``repro_torch.kernels.covgram_screen.ref``) is
held against the reference's numpy oracle ``covgram_screen_ref``, which
computes in the input dtype as the port does (the reference's Pallas path
casts to float32 and is not ground truth at ties — ROADMAP queue 3).  On
integer X with a power-of-two n every covariance entry is a dyadic rational
that both compute exactly, so vals, counts and stats are equal bit for bit,
exact ties included; on Gaussian X the two sum in another order and agree to
1e-12 of the largest |S_ij|.  The CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from repro.kernels.covgram_screen.ops import (
    compact_edges as jax_compact_edges,
    compact_edges_signed as jax_compact_edges_signed,
    pad_for_screen as jax_pad_for_screen,
)
from repro.kernels.covgram_screen.ref import covgram_screen_ref as np_screen_ref
from repro_torch.core import instrument
from repro_torch.kernels.covgram_screen import (
    compact_edges,
    compact_edges_signed,
    covgram_screen_ref,
    covgram_screen_tiles,
    pad_for_screen,
)

RTOL = 1e-12


def _inputs(X, tile, chunk):
    n, p = X.shape
    mu = X.mean(axis=0)
    x_np, mu_np = jax_pad_for_screen(X, mu, block_n=chunk, block_p=tile)
    x_t, mu_t = pad_for_screen(torch.as_tensor(X), mu, block_n=chunk, block_p=tile)
    nt = x_np.shape[1] // tile
    ti, tj = np.triu_indices(nt)
    return x_np, mu_np, x_t, mu_t, ti.astype(np.int32), tj.astype(np.int32)


@pytest.mark.parametrize("n,p,tile,chunk", [(7, 10, 4, 4), (20, 45, 16, 8), (33, 64, 32, 16)])
def test_pad_for_screen_matches_reference(n, p, tile, chunk):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, p))
    x_np, mu_np, x_t, mu_t, _, _ = _inputs(X, tile, chunk)
    assert np.array_equal(x_t.numpy(), x_np) and np.array_equal(mu_t.numpy(), mu_np)
    assert x_t.shape[0] % chunk == 0 and x_t.shape[1] % tile == 0


@pytest.mark.parametrize("seed,p,tile", [(0, 21, 16), (1, 50, 32), (2, 64, 32), (3, 40, 16)])
def test_plain_equals_reference_bitwise_on_integer_data(seed, p, tile):
    rng = np.random.default_rng(seed)
    n = 16
    X = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    Xc = X - X.mean(axis=0)
    vals = np.abs(Xc.T @ Xc / n)[np.triu_indices(p, 1)]
    lam = float(np.sort(vals[vals > 0])[vals[vals > 0].size // 2])  # an existing |S_ij|
    want = np_screen_ref(x_np, mu_np, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    got = covgram_screen_ref(x_t, mu_t, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1][:, 0])
    assert np.array_equal(got[2].numpy(), want[2])
    # a tie entry is not an edge: it never appears in vals
    assert not (np.abs(got[0].numpy()) == lam).any()


@pytest.mark.parametrize("seed,n,p,tile", [(4, 24, 30, 16), (5, 40, 70, 32)])
def test_plain_matches_reference_on_gaussian_data(seed, n, p, tile):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (0.1 + rng.random(p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    Xc = X - X.mean(axis=0)
    vals = np.unique(np.abs(Xc.T @ Xc / n)[np.triu_indices(p, 1)])
    k = vals.size // 2
    lam = float(0.5 * (vals[k] + vals[k + 1]))  # midway: no entry near lam
    want = np_screen_ref(x_np, mu_np, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    got = covgram_screen_ref(x_t, mu_t, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    scale = float(want[2][:, 0].max())
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=RTOL * scale)
    assert np.array_equal(got[1].numpy(), want[1][:, 0])


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((12, 20))
    _, _, x_t, mu_t, ti, tj = _inputs(X, 8, 4)
    instrument.reset("kernels.")
    got = covgram_screen_tiles(x_t, mu_t, ti, tj, 0.2, n_true=12, p_true=20, block_p=8)
    want = covgram_screen_ref(x_t, mu_t, ti, tj, 0.2, n_true=12, p_true=20, block_p=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert instrument.count("kernels.covgram_screen.launches") == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_edges_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, p, tile = 16, 37, 16
    X = rng.standard_normal((n, p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    vals, _, _ = np_screen_ref(x_np, mu_np, ti, tj, 0.3, n_true=n, p_true=p, block_p=tile)
    for port_fn, ref_fn in ((compact_edges, jax_compact_edges),
                            (compact_edges_signed, jax_compact_edges_signed)):
        got = port_fn(torch.as_tensor(vals), ti, tj, block_p=tile)
        want = ref_fn(vals, ti, tj, block_p=tile)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    gi, gj, _ = compact_edges(torch.as_tensor(vals), ti, tj, block_p=tile)
    assert (gi < gj).all() and (gj < p).all()
