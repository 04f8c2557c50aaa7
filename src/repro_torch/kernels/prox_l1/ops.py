"""Public wrapper for the proximal-gradient step: the CUDA kernel on the
card, the plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, lane_vector, library
from repro_torch.kernels.prox_l1.ref import prox_step_ref


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
    t_v = lane_vector("prox_l1", t, B, th)
    lam_v = lane_vector("prox_l1", lam, B, th)
    th, gr = th.contiguous(), gr.contiguous()
    out = torch.empty_like(th)
    if B and b:
        with torch.cuda.device(dev):
            status = getattr(library(), f"prox_l1_launch_{suffix}")(
                th.data_ptr(), gr.data_ptr(), t_v.data_ptr(), lam_v.data_ptr(),
                out.data_ptr(), B, b, torch.cuda.current_stream().cuda_stream,
            )
        check(status, "prox_l1")
        bump("kernels.prox_l1.launches")
    return out[0] if single else out
