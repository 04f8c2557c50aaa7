"""Public wrapper for the forest closed form: the CUDA kernel on the card,
the plain version on the CPU.

A call on the card is one kernel launch and nothing else: lam is read in
place through a pointer and a lane stride, or passed by value for a Python
scalar or a CPU 0-d tensor (``build.lane_operand``), the entry point is
looked up once, the device is entered only when it is not the current one,
and the stream is passed as a raw handle."""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, check_operands, instance, lane_operand, library
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f64" or "f32")."""
    return getattr(library(), f"tree_glasso_launch_{suffix}")


def glasso_forest_stack(blocks: torch.Tensor, lams) -> torch.Tensor:
    """Batched closed-form forest glasso over a (B, b, b) bucket stack.

    ``lams`` is one value for every block (a Python scalar or a 0-d
    tensor) or one a block, shape (B,).  A CPU stack runs the plain
    version; a CUDA stack launches ``csrc/tree_glasso.cu`` (its float64 or
    float32 instance, any b) or raises.  Each launch bumps
    ``kernels.tree_glasso.launches``."""
    if blocks.device.type == "cpu":
        return glasso_forest_ref(blocks, lams)
    B, b = check_operands("tree_glasso", blocks)
    lam_x, lam_stride, lam_value = lane_operand(
        "tree_glasso", "per-block lams", lams, B, blocks
    )
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    if B:
        dev = blocks.device
        other = dev.index != torch.cuda.current_device()
        with torch.cuda.device(dev) if other else contextlib.nullcontext():
            status = _launcher(instance("tree_glasso", blocks.dtype))(
                blocks.data_ptr(), None if lam_x is None else lam_x.data_ptr(), lam_stride,
                lam_value, out.data_ptr(), B, b, torch._C._cuda_getCurrentRawStream(dev.index),
            )
        check(status, "tree_glasso")
        bump("kernels.tree_glasso.launches")
    return out
