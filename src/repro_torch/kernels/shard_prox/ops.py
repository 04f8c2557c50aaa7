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
(device, dtype) that only grows.  The counters are zeroed once, when the
buffer is allocated, and every launch leaves them at zero.  Sharing the
buffer between calls is safe because launches on one stream run in order
and both solvers call from one stream; calls on two streams at once would
need a buffer each."""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, instance, library
from repro_torch.kernels.shard_prox.ref import fused_prox_ref

#: entries a partial sum covers (a tile: ``kThreads`` in csrc/shard_prox.cu)
TILE = 256

#: (device, dtype) -> (partials, per-lane counters)
_SCRATCH: dict[tuple[torch.device, torch.dtype], tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(dev: torch.device, dtype: torch.dtype, n: int, entries: int):
    """The cached (partials, counters) for n lanes of ``entries`` values:
    2 n ceil(entries / TILE) values of ``dtype`` and n zeroed int32
    counters, reallocated only when a call needs more."""
    values = 2 * n * -(-entries // TILE)
    partial, tickets = _SCRATCH.get((dev, dtype), (None, None))
    if partial is None or partial.numel() < values:
        partial = torch.empty(values, dtype=dtype, device=dev)
    if tickets is None or tickets.numel() < n:
        tickets = torch.zeros(n, dtype=torch.int32, device=dev)
    _SCRATCH[(dev, dtype)] = (partial, tickets)
    return partial, tickets


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f64" or "f32")."""
    return getattr(library(), f"shard_prox_launch_{suffix}")


def _threshold(t, n: int, like: torch.Tensor) -> tuple[int | None, int, float]:
    """(pointer, lane stride, value) of the threshold: a 0-d tensor of
    ``like``'s dtype on its device by pointer with stride 0, an (n,) one by
    pointer with its own stride, a Python scalar or a CPU 0-d tensor by
    value; a 0-d tensor on the device in another dtype is converted."""
    if not isinstance(t, torch.Tensor) or (t.ndim == 0 and t.device.type == "cpu"):
        return None, 0, float(t)
    if t.ndim == 0 and t.device == like.device:
        t = t if t.dtype == like.dtype else t.to(like.dtype)
        return t.data_ptr(), 0, 0.0
    if t.shape != (n,) or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(
            f"shard_prox: t must be a scalar or ({n},) {like.dtype} on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    return t.data_ptr(), t.stride(0), 0.0


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
    t_ptr, t_stride, t_value = _threshold(t, n, x)
    z_new = torch.empty_like(x)
    u_new = torch.empty_like(x)
    sums = () if len(shape) == 2 else (n,)
    if not (n and entries):
        return z_new, u_new, x.new_zeros(sums), x.new_zeros(sums)
    rp2 = torch.empty(sums, dtype=dtype, device=dev)
    rd2 = torch.empty(sums, dtype=dtype, device=dev)
    partial, tickets = scratch(dev, dtype, n, entries)
    other = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        status = _launcher(suffix)(
            x.data_ptr(), uu.data_ptr(), zo.data_ptr(), t_ptr, t_stride, t_value,
            z_new.data_ptr(), u_new.data_ptr(), rp2.data_ptr(), rd2.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), n, entries,
            # the device's current stream as a raw handle, as Triton's
            # launcher reads it (torch.cuda.current_stream builds a Stream
            # object each call)
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    check(status, "shard_prox")
    bump("kernels.shard_prox.launches")
    return z_new, u_new, rp2, rd2
