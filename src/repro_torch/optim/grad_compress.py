"""int8 gradient compression with error feedback.

For a data-parallel gradient exchange: quantize each part to int8 with a
per-part float32 scale, sum the parts, dequantize: 4x less all-reduce
traffic than float32 (2x against bf16), for one extra abs-max pass.
Error feedback (the residual carried into the next step) keeps the
compression from biasing convergence [Seide et al. 2014; the 1-bit SGD
lineage].  ``compressed_psum`` takes the per-device parts of a mesh as a
list, as ``core.distributed.psum`` does.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.core.distributed import psum
from repro_torch.train.tree import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(parts: Sequence[torch.Tensor], *, errors: Sequence[torch.Tensor] | None = None):
    """Quantized mean over the parts, one a device (the reference's
    ``compressed_psum`` inside ``shard_map``, whose parts are the devices'
    values of x).  Returns (the mean on the first part's device, the new
    error-feedback residual of each part)."""
    if errors is not None:
        parts = [x + e for x, e in zip(parts, errors)]
    quantized = [quantize_int8(x) for x in parts]
    new_errors = [x - dequantize_int8(q, s) for x, (q, s) in zip(parts, quantized)]
    total = psum([q.to(torch.int32) * s for q, s in quantized])
    return total / len(parts), new_errors


def compress_tree(grads, errors=None):
    """Leaf-wise quantize -> dequantize with error feedback (the local
    simulation path of the tests and the accumulation loop)."""
    if errors is None:
        errors = tree_map(torch.zeros_like, grads)
    qs = tree_map(lambda g, e: quantize_int8(g + e), grads, errors)
    deq = tree_map(lambda g, qe: dequantize_int8(*qe), grads, qs)
    new_err = tree_map(lambda g, e, d: g + e - d, grads, errors, deq)
    return deq, new_err
