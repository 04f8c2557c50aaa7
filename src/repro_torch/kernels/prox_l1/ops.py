"""Public wrapper for the proximal-gradient step: the CUDA kernel on the
card, the plain version on the CPU.

A call on the card is one kernel launch and nothing else: t and lam are
read in place through a pointer and a lane stride, or passed by value for a
Python scalar or a CPU 0-d tensor (``build.lane_operand``), the entry point
is looked up once, the device is entered only when it is not the current
one, and the stream is passed as a raw handle."""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, lane_operand, library
from repro_torch.kernels.prox_l1.ref import prox_step_ref


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f64" or "f32")."""
    return getattr(library(), f"prox_l1_launch_{suffix}")


def prox_step(theta: torch.Tensor, grad: torch.Tensor, t, lam) -> torch.Tensor:
    """soft(theta - t*grad, t*lam) over a (B, b, b) stack or one (b, b)
    block; ``t`` and ``lam`` are scalars or (B,) per-lane values.

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/prox_l1.cu`` (its float64 or float32 instance) or raises.  Each launch bumps
    ``kernels.prox_l1.launches``."""
    if theta.device.type == "cpu":
        return prox_step_ref(theta, grad, t, lam)
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"prox_l1: no kernel for device {dev}")
    suffix = instance("prox_l1", theta.dtype)
    if grad.dtype != theta.dtype:
        raise TypeError(f"prox_l1: grad must be {theta.dtype}, got {grad.dtype}")
    if grad.shape != theta.shape or grad.device != dev:
        raise ValueError(
            f"prox_l1: grad must match theta {tuple(theta.shape)} on {dev}, "
            f"got {tuple(grad.shape)} on {grad.device}"
        )
    single = theta.ndim == 2
    if theta.ndim not in (2, 3) or theta.shape[-1] != theta.shape[-2]:
        raise ValueError(f"prox_l1: theta must be (B, b, b) or (b, b), got {tuple(theta.shape)}")
    th = theta[None] if single else theta
    gr = grad[None] if single else grad
    B, b, _ = th.shape
    t_x, t_stride, t_value = lane_operand("prox_l1", "t", t, B, th)
    lam_x, lam_stride, lam_value = lane_operand("prox_l1", "lam", lam, B, th)
    th, gr = th.contiguous(), gr.contiguous()
    out = torch.empty_like(th)
    if B and b:
        other = dev.index != torch.cuda.current_device()
        with torch.cuda.device(dev) if other else contextlib.nullcontext():
            status = _launcher(suffix)(
                th.data_ptr(), gr.data_ptr(),
                None if t_x is None else t_x.data_ptr(), t_stride, t_value,
                None if lam_x is None else lam_x.data_ptr(), lam_stride, lam_value,
                out.data_ptr(), B, b, torch._C._cuda_getCurrentRawStream(dev.index),
            )
        check(status, "prox_l1")
        bump("kernels.prox_l1.launches")
    return out[0] if single else out
