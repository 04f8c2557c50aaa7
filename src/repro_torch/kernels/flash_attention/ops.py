"""Public wrapper for blockwise attention: the CUDA kernel on the card, the
plain version on the CPU.

The reference's wrapper flattens (B, H) and pads Sq and Skv to its block
sizes; the CUDA kernel masks the ragged rows and keys itself, so no padded
copy exists, and reads K/V head ``bh // group`` for query head ``bh``, so
no repeated K/V exists either.  The output has q's dtype.

``csrc/flash_attention.cu`` has one hand-written body per dtype: float32
runs the register-tiled FP32 body, bf16 the tensor-core body (wgmma fed by
TMA; it also bumps ``kernels.flash_attention.wgmma_launches``).  Each body
has instances at a few head dims (``HEAD_DIMS``); any other d up to
``MAX_HEAD_DIM`` is padded with zero columns to the next instance
(``pad_head_dim``) and the output sliced back, with the scale of the
unpadded d."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.flash_attention.ref import attention_ref

#: each q/k/v dtype's body, by its entry point
_BODIES = {
    torch.float32: "flash_attention_launch_f32",
    torch.bfloat16: "flash_attention_wgmma_launch_bf16",
}
#: the head dims each body has an instance for (wgmma's depth is 16 bf16
#: values; the float32 body takes multiples of 32)
HEAD_DIMS = {torch.float32: (32, 64, 96, 128), torch.bfloat16: (16, 32, 64, 128)}
#: the largest head dim the kernel takes
MAX_HEAD_DIM = 128


def instance_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim of the instance that runs a call of head dim ``d`` in
    ``dtype``: the smallest of ``HEAD_DIMS[dtype]`` at or above d."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head_dim {d} outside 1 .. {MAX_HEAD_DIM}, the head dims "
            "the kernel takes"
        )
    return next(n for n in HEAD_DIMS[dtype] if n >= d)


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 to: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v with zero columns appended to their last axis up to ``to``.
    Attention of the padded tensors at the same scale is the attention of
    the originals in the first d output columns: a zero column adds nothing
    to q . k, and P V's extra columns are zero."""
    d = q.shape[-1]
    if to == d:
        return q, k, v
    return tuple(F.pad(x, (0, to - d)) for x in (q, k, v))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, d) over k, v (B, Hkv, Skv, d), Hq a
    multiple of Hkv; causal masks kpos > qpos, aligned top-left.  ``scale``
    defaults to d**-0.5.  Returns (B, Hq, Sq, d) in q's dtype.

    A CPU tensor runs the plain version at any d; any other tensor must
    have d <= ``MAX_HEAD_DIM``, and a CUDA tensor launches
    ``csrc/flash_attention.cu`` or raises.  Each launch bumps
    ``kernels.flash_attention.launches``, and a bf16 launch (the wgmma body)
    also ``kernels.flash_attention.wgmma_launches``."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    assert Hq % Hkv == 0, "GQA requires Hq to be a multiple of Hkv"
    scale = float(scale if scale is not None else 1.0 / (d**0.5))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.dtype not in _BODIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention: q, k and v must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: k and v must be ({B}, Hkv, Skv, {d}), got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    d_run = instance_head_dim(d, q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v must lie on {q.device}")
    q, k, v = (x.contiguous() for x in pad_head_dim(q, k, v, d_run))
    # both bodies copy 16-byte chunks (cp.async, TMA) from 16-byte aligned rows
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    entry = _BODIES[q.dtype]
    with torch.cuda.device(q.device):
        status = getattr(library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * Hq, Hq // Hkv, Sq, Skv, d_run, scale, int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    check(status, entry)
    bump("kernels.flash_attention.launches")
    if q.dtype == torch.bfloat16:
        bump("kernels.flash_attention.wgmma_launches")
    return out if d_run == d else out[..., :d].contiguous()
