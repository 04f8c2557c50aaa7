"""Plain PyTorch version of the ``flash_attention`` kernel: attention with
the (Sq, Skv) scores materialized in float32.

    K, V repeated over the query heads of their group (GQA)
    s = (q . k) * scale                         float32
    s = -inf where kpos > qpos     (causal; aligned top-left, both from 0)
    o = softmax(s) @ v, cast to q's dtype

The reference's ``attention_ref`` operation for operation.  It holds
B Hq Sq Skv float32 scores at once: a test oracle, never the serving path.
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d)."""
    Hq, Sq, d = q.shape[1:]
    Hkv, Skv = k.shape[1:3]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    kr = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    s = torch.matmul(q.to(torch.float32), kr.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vr).to(q.dtype)
