"""Public wrapper for the fused prox tail: the CUDA kernel on the card, the
plain version on the CPU.

Called once per ADMM iteration with the (bp, bp) iterate of the sharded
oversize solver, or the (N, b, b) bucket stack of the dense ``admm`` solver
with t = lam/rho per lane as an (N,) tensor on the stack's device, so an
adaptive rho never reaches the host.  No padding is needed: the kernel
masks the ragged edge itself."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, lane_vector, library
from repro_torch.kernels.shard_prox.ref import fused_prox_ref


def fused_prox_residual(
    x_new: torch.Tensor, u: torch.Tensor, z_old: torch.Tensor, t
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Z_new, U_new, rp2, rd2) for one (rl, b) shard or an (N, rl, b)
    stack; ``t`` is a scalar or, for a stack, (N,) per-lane values.  rp2 and
    rd2 stay on the device: 0-d for a shard, (N,) for a stack.

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/shard_prox.cu`` (its float64 or float32 instance) or raises.  Each launch bumps
    ``kernels.shard_prox.launches``."""
    if x_new.device.type == "cpu":
        return fused_prox_ref(x_new, u, z_old, t)
    dev = x_new.device
    if dev.type != "cuda":
        raise ValueError(f"shard_prox: no kernel for device {dev}")
    ops = (x_new, u, z_old)
    suffix = instance("shard_prox", x_new.dtype)
    if any(x.dtype != x_new.dtype for x in ops):
        raise TypeError(
            "shard_prox: the operands must share one dtype, got "
            f"{[str(x.dtype) for x in ops]}"
        )
    if x_new.ndim not in (2, 3):
        raise ValueError(
            f"shard_prox: x_new must be (rl, b) or (N, rl, b), got {tuple(x_new.shape)}"
        )
    if any(x.shape != x_new.shape or x.device != dev for x in ops[1:]):
        raise ValueError(
            f"shard_prox: u and z_old must match x_new {tuple(x_new.shape)} on {dev}, "
            f"got {tuple(u.shape)} on {u.device}, {tuple(z_old.shape)} on {z_old.device}"
        )
    single = x_new.ndim == 2
    xs = [x[None] if single else x for x in ops]
    n, rl, b = xs[0].shape
    t_v = lane_vector("shard_prox", t, n, xs[0])
    x, uu, zo = (v.contiguous() for v in xs)
    z_new = torch.empty_like(x)
    u_new = torch.empty_like(x)
    acc = torch.zeros((n, 2), dtype=x.dtype, device=dev)
    entries = rl * b
    if n and entries:
        lib = library()
        partial = torch.empty(
            int(lib.shard_prox_scratch_values(n, entries)), dtype=x.dtype, device=dev
        )
        with torch.cuda.device(dev):
            status = getattr(lib, f"shard_prox_launch_{suffix}")(
                x.data_ptr(), uu.data_ptr(), zo.data_ptr(), t_v.data_ptr(),
                z_new.data_ptr(), u_new.data_ptr(), partial.data_ptr(), acc.data_ptr(),
                n, entries, torch.cuda.current_stream().cuda_stream,
            )
        check(status, "shard_prox")
        bump("kernels.shard_prox.launches")
    if single:
        return z_new[0], u_new[0], acc[0, 0], acc[0, 1]
    return z_new, u_new, acc[:, 0], acc[:, 1]
