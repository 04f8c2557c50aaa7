"""The covariance front end of the large-scale pipeline against the
reference package: the ``covgram`` kernel's plain version, ``microarray_like``
and the estimators ``streaming_covariance`` / ``impute_missing``.

``repro.kernels.covgram.covgram`` runs its Pallas kernel in interpret mode
off the TPU (rows padded with copies of mu, columns with zeros, rescaled to
the true n), as the reference's own tests run it.  Tolerances: the port's
plain version and the reference both accumulate float32 products of the
same float32 (or exactly upcast bf16) values in another order, within
1e-5 of max|S| as in ``tests/test_kernels.py``; the float64 estimators
agree to 1e-12 of max|S|; ``microarray_like`` is bit-equal, and
``impute_missing`` keeps every observed entry bit for bit and imputes the
column means to 1e-14 relative (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.covariance import impute_missing as jax_impute
from repro.covariance import microarray_like as jax_microarray
from repro.covariance import streaming_covariance as jax_streaming
from repro.kernels.covgram.ops import covgram as jax_covgram
from repro.kernels.covgram.ref import covgram_ref as jax_covgram_ref
from repro_torch.covariance import impute_missing, microarray_like, streaming_covariance
from repro_torch.kernels.covgram import covgram, covgram_ref

F32_RTOL = 1e-5
F64_RTOL = 1e-12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,p,bn,bp", [(64, 32, 16, 8), (100, 17, 32, 8), (33, 64, 8, 16), (41, 29, 16, 16)]
)
def test_covgram_plain_matches_reference(n, p, bn, bp, dtype):
    rng = np.random.default_rng(n + p)
    X = rng.standard_normal((n, p)) * (0.2 + rng.random(p)) + 2.0
    xj = jnp.asarray(X, getattr(jnp, dtype))
    xt = torch.as_tensor(X).to(getattr(torch, dtype))
    got = covgram(xt)
    assert got.dtype == torch.float32 and got.shape == (p, p)
    got = got.numpy()
    scale = float(np.abs(got).max())
    for want in (np.asarray(jax_covgram(xj, block_n=bn, block_p=bp)),
                 np.asarray(jax_covgram_ref(xj))):
        assert want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * scale)
    np.testing.assert_array_equal(got, covgram_ref(xt).numpy())


def test_covgram_casts_float64_as_the_reference_does():
    """float64 X is cast to float32 before the product, as the reference's
    wrapper casts it: the result is the float32 input's, not a float64 Gram
    rounded at the end."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((20, 9)) + 1e3
    got = covgram(torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got, covgram(torch.as_tensor(X, dtype=torch.float32)).numpy())
    want = np.asarray(jax_covgram_ref(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("n,p,seed", [(80, 1200, 7), (40, 300, 0), (12, 64, 5)])
def test_microarray_like_is_bit_equal(n, p, seed):
    np.testing.assert_array_equal(microarray_like(n, p, seed=seed),
                                  jax_microarray(n, p, seed=seed))


@pytest.mark.parametrize("n,chunk", [(50, 16), (64, 64), (7, 4096)])
def test_streaming_covariance_matches_reference(n, chunk):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, 13)) * 3.0 + 1.0
    got = streaming_covariance(X, chunk=chunk, device="cpu").numpy()
    want = np.asarray(jax_streaming(jnp.asarray(X), chunk=chunk))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_RTOL * float(np.abs(want).max()))
    np.testing.assert_array_equal(got, got.T)


def test_streaming_covariance_accumulates_bf16_in_float32():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((40, 10))
    got = streaming_covariance(torch.as_tensor(X).to(torch.bfloat16), chunk=16, device="cpu")
    want = np.asarray(jax_streaming(jnp.asarray(X, jnp.bfloat16), chunk=16))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("nan_cols", [(), (2,), (0, 5)])
def test_impute_missing_matches_reference(nan_cols):
    rng = np.random.default_rng(len(nan_cols))
    X = rng.standard_normal((30, 8))
    X[rng.random(X.shape) < 0.1] = np.nan
    for c in nan_cols:  # whole columns missing: imputed as zeros
        X[:, c] = np.nan
    got = impute_missing(X, device="cpu").numpy()
    want = np.asarray(jax_impute(jnp.asarray(X)))
    assert not np.isnan(got).any()
    seen = ~np.isnan(X)
    np.testing.assert_array_equal(got[seen], X[seen])
    # the column means sum in another order: within 1e-14 relative
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    for c in nan_cols:
        assert (got[:, c] == 0).all()
