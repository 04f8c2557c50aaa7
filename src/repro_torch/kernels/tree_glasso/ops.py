"""Public wrapper for the forest closed form: the CUDA kernel on the card,
the plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, check_operands, instance, library
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref


def glasso_forest_stack(blocks: torch.Tensor, lams: torch.Tensor) -> torch.Tensor:
    """Batched closed-form forest glasso over a (B, b, b) bucket stack.

    ``lams`` is per-block, shape (B,).  A CPU stack runs the plain version;
    a CUDA stack launches ``csrc/tree_glasso.cu`` (its float64 or float32
    instance, any b) or raises.  Each launch bumps ``kernels.tree_glasso.launches``."""
    if blocks.device.type == "cpu":
        return glasso_forest_ref(blocks, lams)
    B, b = check_operands("tree_glasso", blocks, lams)
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    if B == 0:
        return out
    with torch.cuda.device(blocks.device):
        status = getattr(library(), f"tree_glasso_launch_{instance('tree_glasso', blocks.dtype)}")(
            blocks.data_ptr(), lams.contiguous().data_ptr(), out.data_ptr(),
            B, b, torch.cuda.current_stream().cuda_stream,
        )
    check(status, "tree_glasso")
    bump("kernels.tree_glasso.launches")
    return out
