"""Shared layers: norms, dense projections, SwiGLU MLP, RoPE, embeddings.

Weights keep the reference's layout, (in, out) for a projection, so
``dense`` is ``x @ w (+ b)`` and a reference parameter tree converts
without transposes (``models/convert.py``).  Norms compute in float32 and
cast back to the input's dtype, as the reference does; a float64 input
(the training oracle's) keeps float64 (``acc_dtype``).

Initialisation draws in place on the parameter's own device from an
explicit ``torch.Generator``: truncated normals on [-2, 2] times a scale
(d_in**-0.5 for projections, 1.0 for the embedding table), ones for norm
scales and zeros for biases — the reference's ``layers.py`` scales.  The
two packages' generators differ, so the same seed gives other numbers;
parity tests convert the reference's parameters instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def truncnorm_(t: torch.Tensor, scale: float, generator: torch.Generator | None) -> torch.Tensor:
    """Fill ``t`` in place with scale * (a standard normal truncated to
    [-2, 2])."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        return t.mul_(scale)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a norm, a softmax or the loss computes in: float32, or the
    input's own where it is wider.  For bfloat16 and float32 this is the
    reference's float32; a float64 model stays float64 throughout."""
    return torch.promote_types(dtype, torch.float32)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """y = x @ w (+ b); w is (in_dim, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False, dtype, device):
        super().__init__()
        self.w = _param((in_dim, out_dim), dtype, device)
        self.b = _param((out_dim,), dtype, device) if bias else None

    def reset(self, generator: torch.Generator | None) -> None:
        truncnorm_(self.w, self.w.shape[0] ** -0.5, generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), dtype, device)

    def reset(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps=self.eps)


class Embedding(nn.Module):
    """A (vocab, dim) table, initialised at scale 1.0."""

    def __init__(self, vocab: int, dim: int, *, dtype, device):
        super().__init__()
        self.table = _param((vocab, dim), dtype, device)

    def reset(self, generator: torch.Generator | None) -> None:
        truncnorm_(self.table, 1.0, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(self.table, ids)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype, device):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wg = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d_model, dtype=dtype, device=device)

    def reset(self, generator: torch.Generator | None) -> None:
        for m in (self.wi, self.wg, self.wo):
            m.reset(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.wi.w, self.wg.w, self.wo.w)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(acc)).to(x.dtype)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``.  The reference switches to a one-hot
    matmul at a vocab of 8192 or more, which only serves its SPMD
    partitioner; the gather gives the same rows exactly, without a
    (B, S, vocab) one-hot (623 MB at qwen2.5-3b's vocab and 1024 tokens).
    Its backward sums the rows of each id in a fixed order on the card
    too (``embedding_dense_backward``), so a training step is
    reproducible bit for bit."""
    return F.embedding(ids.long(), table)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ wg) * (x @ wi)
    return h @ wo


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin), each (..., S, head_dim / 2)
    float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exponent)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, d); cos/sin: (B, S, d/2) or (S, d/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos_, sin_ = cos[None, None], sin[None, None]
    else:
        cos_, sin_ = cos[:, None], sin[:, None]
    out1 = x1 * cos_ - x2 * sin_
    out2 = x2 * cos_ + x1 * sin_
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
