"""Sample covariance / correlation estimators in torch on the engine's
device.

``sample_covariance``, ``sample_correlation`` and ``streaming_covariance``
take an (n, p) data matrix (numpy or a tensor) and return a (p, p)
symmetric PSD tensor; ``impute_missing`` mean-imputes the NaNs of one.  Accumulation is float32-or-wider whatever the input
dtype: bf16/f16 inputs are upcast one row chunk at a time, so the
full-precision copy of X never exists.  The reference computes these with
plain matrix products outside any TPU kernel, so ``torch.matmul`` is their
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.options import resolve_device

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _as_tensor(X, device) -> torch.Tensor:
    """X on its own device when it is a tensor and no device is asked for;
    else on ``device`` (``"cuda"`` by default, which raises without CUDA)."""
    if isinstance(X, torch.Tensor) and device is None:
        return X
    dev = resolve_device("cuda" if device is None else device)
    if isinstance(X, torch.Tensor):
        return X.to(dev)
    return torch.as_tensor(np.asarray(X)).to(dev)


def sample_covariance(X, *, ddof: int = 0, chunk: int = 1024, device=None) -> torch.Tensor:
    """S = (X - mean)' (X - mean) / (n - ddof), symmetrized.

    The paper's experiments use the maximum-likelihood normalization
    (ddof=0).  float32/float64 inputs take one product; bf16/f16 inputs
    accumulate the mean and the Gram in float32 over ``chunk``-row slabs,
    each slab upcast on its own."""
    X = _as_tensor(X, device)
    n, p = X.shape
    denom = max(n - ddof, 1)
    if X.dtype in _LOW_PRECISION:
        acc = torch.float32
        mu = torch.zeros(p, dtype=acc, device=X.device)
        for r0 in range(0, n, chunk):
            mu += X[r0 : r0 + chunk].to(acc).sum(dim=0)
        mu /= n
        S = torch.zeros((p, p), dtype=acc, device=X.device)
        for r0 in range(0, n, chunk):
            c = X[r0 : r0 + chunk].to(acc) - mu
            S += c.T @ c
        S = S / denom
    else:
        Xc = X - X.mean(dim=0, keepdim=True)
        S = (Xc.T @ Xc) / denom
    return 0.5 * (S + S.T)


def sample_correlation(X, *, ddof: int = 0, device=None) -> torch.Tensor:
    """Correlation matrix — what the paper uses for the microarray examples.

    With a correlation input every |S_ij| <= 1 (i != j), so all nodes
    isolate at lambda >= 1 (paper Section 4.2).  ``ddof`` cancels in exact
    arithmetic; it is there for symmetry with ``sample_covariance``."""
    S = sample_covariance(X, ddof=ddof, device=device)
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    R = S / torch.outer(d, d)
    eye = torch.eye(S.shape[0], dtype=torch.bool, device=S.device)
    R = torch.where(eye, torch.ones((), dtype=R.dtype, device=R.device), R)
    return 0.5 * (R + R.T)


def streaming_covariance(X, *, chunk: int = 4096, device=None) -> torch.Tensor:
    """Covariance in one pass over row chunks of X, for n too large to
    center at once: accumulate the Gram matrix and the column sums,
    S = (X'X - n mu mu') / n, symmetrized.  bf16/f16 inputs accumulate in
    float32, each chunk upcast on its own."""
    X = _as_tensor(X, device)
    n, p = X.shape
    acc = torch.float32 if X.dtype in _LOW_PRECISION else X.dtype
    gram = torch.zeros((p, p), dtype=acc, device=X.device)
    ssum = torch.zeros(p, dtype=acc, device=X.device)
    for r0 in range(0, n, chunk):
        xc = X[r0 : r0 + chunk].to(acc)
        gram += xc.T @ xc
        ssum += xc.sum(dim=0)
    mu = ssum / n
    S = gram / n - torch.outer(mu, mu)
    return 0.5 * (S + S.T)


def impute_missing(X, *, device=None) -> torch.Tensor:
    """Mean-impute NaNs per feature (paper Section 4.2: examples (B) and (C)
    have few missing values, imputed by the mean of the observed
    expressions); an all-NaN column becomes zeros."""
    X = _as_tensor(X, device)
    mask = torch.isnan(X)
    cnt = torch.clamp((~mask).sum(dim=0), min=1)
    mu = torch.where(mask, torch.zeros((), dtype=X.dtype, device=X.device), X).sum(dim=0) / cnt
    return torch.where(mask, mu[None, :], X)
