"""Public wrapper for the fused joint prox step: the CUDA kernel on the
card, the plain version on the CPU.

Called once per iteration of the joint ADMM's Z-update with the whole
(n, K, b, b) bucket stack and the per-lane t = [lam1/rho, lam2/rho] as an
(n, 2) tensor on the stack's device, read in place by pointer, so an
adaptive rho never reaches the host.  No padding is needed: the kernel
masks the ragged edge itself.

A call on the card is one kernel launch and nothing else: the cross-block
sums finish inside the same launch, the outputs (Z_new, U_new, rp2, rd2)
are views of one allocation the kernel writes whole, and the partials, the
shared-memory shape's work region and the per-lane counters live in a
scratch buffer cached per (device, dtype, stream) that only grows.  The
counters are zeroed once, when the buffer is allocated, and every launch
leaves them at zero.  Calls on one stream share a buffer because its
launches run in order; each stream has its own, and a lock keeps one
thread's lookup and launch from interleaving with another's (the server
solves on its batcher thread and on callers' threads at once)."""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, library
from repro_torch.kernels.joint_prox.ref import PENALTIES, joint_prox_ref

#: the register shape keeps a lane's K class values in registers, one
#: template instance per K up to this; above it the wrapper picks the
#: shared-memory shape, which takes any K
MAX_CLASSES = 16

#: (device, dtype, raw stream) -> (partials and work region, per-lane
#: counters)
_SCRATCH: dict[tuple[torch.device, torch.dtype, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: held from a call's scratch lookup until its launch is enqueued
_LOCK = threading.Lock()


@functools.cache
def scratch_values(n: int, K: int, b: int, smem_shape: bool, itemsize: int) -> int:
    """Values of scratch the launcher needs for n lanes of (K, b, b), asked
    of the library once per shape."""
    return int(library().joint_prox_scratch_values(n, K, b, int(smem_shape), itemsize))


def scratch(dev: torch.device, dtype: torch.dtype, stream: int, n: int, values: int):
    """One stream's cached (scratch, counters) for ``values`` values of
    ``dtype`` and n zeroed int32 counters, reallocated only when a call
    needs more; called under ``_LOCK``."""
    key = (dev, dtype, stream)
    buf, tickets = _SCRATCH.get(key, (None, None))
    if buf is None or buf.numel() < values:
        buf = torch.empty(values, dtype=dtype, device=dev)
    if tickets is None or tickets.numel() < n:
        tickets = torch.zeros(n, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (buf, tickets)
    return buf, tickets


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f64" or "f32")."""
    return getattr(library(), f"joint_prox_launch_{suffix}")


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
    numel = theta.numel()
    # Z_new, U_new, rp2 and rd2: views of one allocation
    z_new, u_new, rp2, rd2 = torch.empty(
        2 * numel + 2 * n, dtype=theta.dtype, device=dev
    ).split([numel, numel, n, n])
    z_new, u_new = z_new.view(theta.shape), u_new.view(theta.shape)
    if n == 0 or K == 0 or b == 0:
        return z_new, u_new, rp2.zero_(), rd2.zero_()
    smem_shape = K > MAX_CLASSES
    values = scratch_values(n, K, b, smem_shape, theta.element_size())
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    other = dev.index != torch.cuda.current_device()
    with _LOCK, torch.cuda.device(dev) if other else contextlib.nullcontext():
        buf, tickets = scratch(dev, theta.dtype, stream, n, values)
        status = _launcher(suffix)(
            theta.data_ptr(), u.data_ptr(), z_old.data_ptr(), t.data_ptr(),
            z_new.data_ptr(), u_new.data_ptr(), rp2.data_ptr(), rd2.data_ptr(),
            buf.data_ptr(), tickets.data_ptr(), n, K, b, int(penalty == "fused"),
            int(smem_shape), stream,
        )
    check(status, "joint_prox")
    bump("kernels.joint_prox.launches")
    return z_new, u_new, rp2, rd2
