"""Public wrapper for the centered Gram: the CUDA kernel on the card, the
plain version on the CPU.

The reference's wrapper pads rows with copies of mu and columns with zeros
and rescales from the padded row count to the true one; the CUDA kernel
masks the ragged edges itself and divides by the true n, so no padded copy
of X exists.  float32 and bf16 X go to the kernel as they are (bf16 is
upcast per element as it is loaded); any other floating dtype is cast to
float32 first, as the reference casts it.  The output is always float32.
mu is the float32 column mean, computed here as the reference's wrapper
computes it outside its kernel.  Beside that, a call on the card is the
kernel's launch: the entry point is looked up once, the device is entered
only when it is not the current one, and the stream is passed as a raw
handle."""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.covgram.ref import covgram_ref

#: X dtypes with a kernel instance, and the suffix of its entry point
_INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _launcher(suffix: str):
    """The kernel instance's entry point ("f32" or "bf16")."""
    return getattr(library(), f"covgram_launch_{suffix}")


def covgram(x: torch.Tensor) -> torch.Tensor:
    """S = (X - mu)'(X - mu)/n for an (n, p) tensor X, float32 (p, p) out.

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/covgram.cu`` or raises.  Each launch bumps
    ``kernels.covgram.launches``."""
    if x.device.type == "cpu":
        return covgram_ref(x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"covgram: no kernel for device {dev}")
    if x.ndim != 2:
        raise ValueError(f"covgram: X must be (n, p), got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"covgram: X must be a floating dtype, got {x.dtype}")
    if x.dtype not in _INSTANCES:
        x = x.to(torch.float32)
    x = x.contiguous()
    n, p = x.shape
    mu = torch.mean(x, dim=0, dtype=torch.float32)
    out = torch.empty((p, p), dtype=torch.float32, device=dev)
    if n == 0:  # 0/0, as the plain version gives
        return out.fill_(float("nan"))
    other = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        status = _launcher(_INSTANCES[x.dtype])(
            x.data_ptr(), mu.data_ptr(), out.data_ptr(), n, p,
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    check(status, "covgram")
    bump("kernels.covgram.launches")
    return out
