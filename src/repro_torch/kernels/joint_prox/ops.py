"""Public wrapper for the fused joint prox step: the CUDA kernel on the
card, the plain version on the CPU.

Called once per iteration of the joint ADMM's Z-update with the whole
(n, K, b, b) bucket stack and the per-lane t = [lam1/rho, lam2/rho] as an
(n, 2) tensor on the stack's device, so an adaptive rho never reaches the
host.  No padding is needed: the kernel masks the ragged edge itself."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, library
from repro_torch.kernels.joint_prox.ref import PENALTIES, joint_prox_ref

#: the register shape keeps a lane's K class values in registers, one
#: template instance per K up to this; above it the wrapper picks the
#: shared-memory shape, which takes any K
MAX_CLASSES = 16


def joint_prox_step(
    theta: torch.Tensor,
    u: torch.Tensor,
    z_old: torch.Tensor,
    t: torch.Tensor,
    *,
    penalty: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Z_new, U_new, rp2, rd2) for a bucket of lanes.

    theta/u/z_old: (n, K, b, b); t: (n, 2).  A CPU stack runs the plain
    version; a CUDA stack launches ``csrc/joint_prox.cu`` (its float64 or
    float32 instance; the register shape for K <= ``MAX_CLASSES``, the
    shared-memory shape above) or raises.  Each launch bumps
    ``kernels.joint_prox.launches``."""
    if penalty not in PENALTIES:
        raise ValueError(f"unknown joint penalty {penalty!r}; available: {PENALTIES}")
    if theta.device.type == "cpu":
        return joint_prox_ref(theta, u, z_old, t, penalty=penalty)
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"joint_prox: no kernel for device {dev}")
    ops = (theta, u, z_old, t)
    suffix = instance("joint_prox", theta.dtype)
    if any(x.dtype != theta.dtype for x in ops):
        raise TypeError(
            "joint_prox: the operands must share one dtype, got "
            f"{[str(x.dtype) for x in ops]}"
        )
    if theta.ndim != 4 or theta.shape[2] != theta.shape[3]:
        raise ValueError(f"joint_prox: theta must be (n, K, b, b), got {tuple(theta.shape)}")
    n, K, b, _ = theta.shape
    if u.shape != theta.shape or z_old.shape != theta.shape or t.shape != (n, 2):
        raise ValueError(
            f"joint_prox: u and z_old must match theta {tuple(theta.shape)} and t be "
            f"({n}, 2); got {tuple(u.shape)}, {tuple(z_old.shape)}, {tuple(t.shape)}"
        )
    if any(x.device != dev for x in ops):
        raise ValueError(f"joint_prox: every operand must lie on {dev}")
    theta, u, z_old, t = (x.contiguous() for x in ops)
    z_new = torch.empty_like(theta)
    u_new = torch.empty_like(theta)
    acc = torch.zeros((n, 2), dtype=theta.dtype, device=dev)
    if n == 0 or K == 0 or b == 0:
        return z_new, u_new, acc[:, 0], acc[:, 1]
    lib = library()
    smem_shape = int(K > MAX_CLASSES)
    scratch = torch.empty(
        int(lib.joint_prox_scratch_values(n, K, b, smem_shape, theta.element_size())),
        dtype=theta.dtype, device=dev,
    )
    with torch.cuda.device(dev):
        status = getattr(lib, f"joint_prox_launch_{suffix}")(
            theta.data_ptr(), u.data_ptr(), z_old.data_ptr(), t.data_ptr(),
            z_new.data_ptr(), u_new.data_ptr(), scratch.data_ptr(), acc.data_ptr(),
            n, K, b, int(penalty == "fused"), smem_shape,
            torch.cuda.current_stream().cuda_stream,
        )
    check(status, "joint_prox")
    bump("kernels.joint_prox.launches")
    return z_new, u_new, acc[:, 0], acc[:, 1]
