"""Concrete random batches for the LM substrate: the token batch of a
(config, shape) cell, drawn with numpy's ``default_rng(seed)`` in the
reference's order, so one seed gives the reference's tokens exactly."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import TORCH_DTYPES


def _token_batch_shapes(cfg: ArchConfig, shape: ShapeConfig, *, with_targets: bool):
    """{name: (shape, dtype)} of the cell's inputs, in the reference's
    order."""
    B, S = shape.global_batch, shape.seq_len
    dtype = TORCH_DTYPES[cfg.dtype]
    batch = {}
    if cfg.encoder_decoder:
        enc_len = min(cfg.enc_len, S)
        batch["frames"] = ((B, enc_len, cfg.d_model), dtype)
        batch["tokens"] = ((B, S), torch.int32)
        if with_targets:
            batch["targets"] = ((B, S), torch.int32)
    elif cfg.frontend:
        F = cfg.frontend_len
        batch["frontend"] = ((B, F, cfg.d_model), dtype)
        batch["tokens"] = ((B, S - F), torch.int32)
        if with_targets:
            batch["targets"] = ((B, S - F), torch.int32)
    else:
        batch["tokens"] = ((B, S), torch.int32)
        if with_targets:
            batch["targets"] = ((B, S), torch.int32)
    return batch


def make_batch(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0, device="cpu") -> dict:
    """A concrete random batch for the cell, on ``device``: token ids
    uniform in [0, vocab), other inputs standard normal."""
    rng = np.random.default_rng(seed)
    shapes = _token_batch_shapes(cfg, shape, with_targets=(shape.kind == "train"))
    out = {}
    for k, (s, d) in shapes.items():
        if d == torch.int32:
            a = torch.as_tensor(rng.integers(0, cfg.vocab, size=s).astype(np.int32))
        else:
            a = torch.as_tensor(rng.standard_normal(s)).to(d)
        out[k] = a.to(device)
    return out
