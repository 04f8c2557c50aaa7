"""Public wrapper for the fused prox tail: the CUDA kernel on the card, the
plain version on the CPU.

Called once per ADMM iteration with the (bp, bp) iterate of the sharded
oversize solver (t = lam/rho a 0-d tensor), or the (N, b, b) bucket stack of
the dense ``admm`` solver (t = lam/rho per lane, an (N,) tensor on the
stack's device), so an adaptive rho never reaches the host.  No padding is
needed: the kernel masks the ragged edge itself.

A call on the card is one kernel launch and nothing else: t is read in
place through a pointer and a lane stride (or passed by value for a Python
scalar), the cross-block sums finish inside the same launch, and the
partials and per-lane counters live in a scratch buffer cached per
(device, dtype, stream) that only grows.  The counters are zeroed once,
when the buffer is allocated, and every launch leaves them at zero.  Calls
on one stream share a buffer because its launches run in order; each
stream has its own, and a lock keeps one thread's lookup and launch from
interleaving with another's (the server solves on its batcher thread and
on callers' threads at once)."""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, lane_operand, library
from repro_torch.kernels.shard_prox.ref import fused_prox_ref

#: entries a partial sum covers (a tile: ``kThreads`` in csrc/shard_prox.cu)
TILE = 256

#: (device, dtype, raw stream) -> (partials, per-lane counters)
_SCRATCH: dict[tuple[torch.device, torch.dtype, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: held from a call's scratch lookup until its launch is enqueued
_LOCK = threading.Lock()


def scratch(dev: torch.device, dtype: torch.dtype, stream: int, n: int, entries: int):
    """One stream's cached (partials, counters) for n lanes of ``entries``
    values: 2 n ceil(entries / TILE) values of ``dtype`` and n zeroed int32
    counters, reallocated only when a call needs more; called under
    ``_LOCK``."""
    values = 2 * n * -(-entries // TILE)
    key = (dev, dtype, stream)
    partial, tickets = _SCRATCH.get(key, (None, None))
    if partial is None or partial.numel() < values:
        partial = torch.empty(values, dtype=dtype, device=dev)
    if tickets is None or tickets.numel() < n:
        tickets = torch.zeros(n, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (partial, tickets)
    return partial, tickets


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f64" or "f32")."""
    return getattr(library(), f"shard_prox_launch_{suffix}")


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
    dev, dtype, shape = x_new.device, x_new.dtype, x_new.shape
    if dev.type != "cuda":
        raise ValueError(f"shard_prox: no kernel for device {dev}")
    suffix = instance("shard_prox", dtype)
    if u.dtype != dtype or z_old.dtype != dtype:
        raise TypeError(
            f"shard_prox: the operands must share one dtype, got {dtype}, {u.dtype}, "
            f"{z_old.dtype}"
        )
    if len(shape) not in (2, 3):
        raise ValueError(f"shard_prox: x_new must be (rl, b) or (N, rl, b), got {tuple(shape)}")
    if u.shape != shape or z_old.shape != shape or u.device != dev or z_old.device != dev:
        raise ValueError(
            f"shard_prox: u and z_old must match x_new {tuple(shape)} on {dev}, "
            f"got {tuple(u.shape)} on {u.device}, {tuple(z_old.shape)} on {z_old.device}"
        )
    x, uu, zo = x_new.contiguous(), u.contiguous(), z_old.contiguous()
    n, entries = (1, x.numel()) if len(shape) == 2 else (shape[0], shape[1] * shape[2])
    t_x, t_stride, t_value = lane_operand("shard_prox", "t", t, n, x)
    z_new = torch.empty_like(x)
    u_new = torch.empty_like(x)
    sums = () if len(shape) == 2 else (n,)
    if not (n and entries):
        return z_new, u_new, x.new_zeros(sums), x.new_zeros(sums)
    rp2 = torch.empty(sums, dtype=dtype, device=dev)
    rd2 = torch.empty(sums, dtype=dtype, device=dev)
    # the device's current stream as a raw handle, as Triton's launcher
    # reads it (torch.cuda.current_stream builds a Stream object each call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    other = dev.index != torch.cuda.current_device()
    with _LOCK, torch.cuda.device(dev) if other else contextlib.nullcontext():
        partial, tickets = scratch(dev, dtype, stream, n, entries)
        status = _launcher(suffix)(
            x.data_ptr(), uu.data_ptr(), zo.data_ptr(),
            None if t_x is None else t_x.data_ptr(), t_stride, t_value,
            z_new.data_ptr(), u_new.data_ptr(), rp2.data_ptr(), rd2.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), n, entries, stream,
        )
    check(status, "shard_prox")
    bump("kernels.shard_prox.launches")
    return z_new, u_new, rp2, rd2
