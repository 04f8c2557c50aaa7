"""Public wrapper for blockwise attention: the CUDA kernel on the card, the
plain version on the CPU.

The reference's wrapper flattens (B, H) and pads Sq and Skv to its block
sizes; the CUDA kernel masks the ragged rows and keys itself, so no padded
copy exists, and reads K/V head ``bh // group`` for query head ``bh``, so
no repeated K/V exists either.  The output has q's dtype.

``csrc/flash_attention.cu`` has two hand-written bodies, chosen here by
dtype and head dim: bf16 at d in ``WGMMA_HEAD_DIMS`` runs the tensor-core
body (wgmma fed by TMA; it also bumps
``kernels.flash_attention.wgmma_launches``), every float32 call and bf16 at
d in {4, 8} the SIMT body (float32 FMAs, bf16 upcast as it is staged)."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.flash_attention.ref import attention_ref

#: q/k/v dtypes with a kernel instance, and the suffix of its entry point
_INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: head dims the kernel has an instance for
HEAD_DIMS = (4, 8, 16, 32, 64, 128)
#: bf16 head dims the wgmma body takes (wgmma's depth is 16 bf16 values)
WGMMA_HEAD_DIMS = (16, 32, 64, 128)


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

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/flash_attention.cu`` or raises.  Each launch bumps
    ``kernels.flash_attention.launches``, and a launch of the wgmma body
    also ``kernels.flash_attention.wgmma_launches``."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    assert Hq % Hkv == 0, "GQA requires Hq to be a multiple of Hkv"
    scale = float(scale if scale is not None else 1.0 / (d**0.5))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _INSTANCES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention: q, k and v must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: k and v must be ({B}, Hkv, Skv, {d}), got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v must lie on {q.device}")
    wgmma = q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
    q, k, v = (x.contiguous() for x in (q, k, v))
    if wgmma:  # TMA reads from 16-byte aligned addresses only
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    entry = ("flash_attention_wgmma_launch_bf16" if wgmma
             else f"flash_attention_launch_{_INSTANCES[q.dtype]}")
    with torch.cuda.device(q.device):
        status = getattr(library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * Hq, Hq // Hkv, Sq, Skv, d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    check(status, entry)
    bump("kernels.flash_attention.launches")
    if wgmma:
        bump("kernels.flash_attention.wgmma_launches")
    return out
