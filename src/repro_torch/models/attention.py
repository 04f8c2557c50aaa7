"""Grouped-query attention (with the QKV-bias variant), with prefill and
decode KV-cache paths.

Cache contract (decode): caches are preallocated at their full length; a
decode step writes the new token's K/V at position ``pos`` in place and
attends over kpos <= pos, so a step costs O(S) reads and no reallocation.
The reference writes with ``dynamic_update_slice`` into a new array; here
the write mutates the cache tensor the caller passed, and the returned
cache is that same tensor.

Prefill ("causal" and "full" modes) takes ``use_flash`` as the reference
does: the blockwise kernel (``kernels/flash_attention``) in place of the
dense or chunked score paths.  ``DecoderLM`` sets it on the card.  Decode
never uses it: its one query row sits at ``pos``, not at row 0, and the
kernel's causal mask is aligned top-left.

MLA (DeepSeek-V2's multi-head latent attention, ``mla_apply``) caches one
latent vector and one shared rope key a token, ``{"c": (B, S, kv_lora),
"kr": (B, S, rope)}``.  Prefill expands the latent into per-head keys and
values and runs the dense or chunked score paths (q/k dim nope + rope, v
dim its own); decode scores the query against the latent cache directly
(the absorbed form).  The reference's ``mla_apply`` has no ``use_flash``,
so MLA never runs the kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Dense, acc_dtype, rope_apply

NEG_INF = -1e30

# q-chunking threshold: above this query length the S^2 score matrix stops
# fitting device memory (34 GB a layer for a 72B model at 32k), so
# attention runs as a loop over q blocks.  ``use_flash`` replaces both.
ATTN_CHUNK_THRESHOLD = 4096
ATTN_Q_CHUNK = 1024


def _sdpa(q, k, v, *, scale, mask) -> torch.Tensor:
    """q: (B, H, Sq, d), k/v: (B, Hkv, Skv, d) with GQA broadcast; mask:
    (Sq, Skv) or (B, 1, Sq, Skv) boolean (True = attend), or None.  Scores,
    softmax and the weighted sum in float32 (float64 for float64 inputs),
    the output in q's dtype.

    The group's query heads are folded into the rows of one product per KV
    head, so K and V are read as they are: broadcasting them over the group
    would copy the whole cache ``group`` times per layer (the reference
    warns against whole-cache copies for the same reason)."""
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    acc = acc_dtype(q.dtype)
    qg = q.reshape(B, Hkv, group * Sq, d).to(acc)
    s = torch.matmul(qg, k.to(acc).transpose(-1, -2)) * scale
    s = s.view(B, Hkv, group, Sq, Skv)
    if mask is not None:
        m = mask if mask.ndim == 4 else mask[None, None]
        s = torch.where(m[:, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).view(B, Hkv, group * Sq, Skv)
    o = torch.matmul(p, v.to(acc))
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def _dus_seq(cache: torch.Tensor, new_vals: torch.Tensor, pos, axis: int) -> torch.Tensor:
    """Write ``new_vals`` into ``cache`` at ``pos`` along ``axis``, in
    place; the start is clamped so the update fits, as
    ``dynamic_update_slice`` clamps it."""
    n = new_vals.shape[axis]
    start = min(max(int(pos), 0), cache.shape[axis] - n)
    cache.narrow(axis, start, n).copy_(new_vals)
    return cache


def causal_mask(Sq: int, Skv: int, offset: int = 0, *, device=None) -> torch.Tensor:
    """True where query may attend: kpos <= qpos + offset."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Skv, device=device)[None, :]
    return kpos <= qpos


def _sdpa_chunked(q, k, v, *, scale, causal, q_chunk=ATTN_Q_CHUNK) -> torch.Tensor:
    """Same contract as ``_sdpa`` over q chunks: transient score buffers are
    (B, H, q_chunk, Skv) instead of (B, H, Sq, Skv)."""
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    acc = acc_dtype(q.dtype)
    kt = k.to(acc).transpose(-1, -2)
    vf = v.to(acc)
    kpos = torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk]
        n = qc.shape[2]
        qg = qc.reshape(B, Hkv, group * n, d).to(acc)
        s = (torch.matmul(qg, kt) * scale).view(B, Hkv, group, n, Skv)
        if causal:
            qpos = c0 + torch.arange(n, device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).view(B, Hkv, group * n, Skv)
        o = torch.matmul(p, vf).to(q.dtype)
        outs.append(o.reshape(B, H, n, v.shape[-1]))
    return torch.cat(outs, dim=2)


class GQAttention(nn.Module):
    """The projections of one GQA block: wq, wk, wv (with bias when the
    config has QKV bias) and wo, each (in, out)."""

    def __init__(self, d_model, n_heads, n_kv_heads, head_dim, *, bias=False, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d_model, n_heads * head_dim, bias=bias, **kw)
        self.wk = Dense(d_model, n_kv_heads * head_dim, bias=bias, **kw)
        self.wv = Dense(d_model, n_kv_heads * head_dim, bias=bias, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, **kw)

    def reset(self, generator: torch.Generator | None) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset(generator)


def gqa_init(d_model, n_heads, n_kv_heads, head_dim, *, bias=False, dtype, device,
             generator: torch.Generator | None = None) -> GQAttention:
    p = GQAttention(d_model, n_heads, n_kv_heads, head_dim, bias=bias, dtype=dtype,
                    device=device)
    p.reset(generator)
    return p


def _split_heads(x, n, d):
    B, S, _ = x.shape
    return x.reshape(B, S, n, d).transpose(1, 2)


def _merge_heads(x):
    B, H, S, d = x.shape
    return x.transpose(1, 2).reshape(B, S, H * d)


def gqa_apply(
    p: GQAttention, x, *, n_heads, n_kv_heads, head_dim,
    cos=None, sin=None, mode="causal",
    x_kv=None, cache=None, pos=None, use_flash=False,
):
    """mode: 'causal' | 'full' | 'cross' | 'decode' | 'cross_decode'.

    decode: x is (B, 1, D); cache = {'k', 'v'} preallocated (B, Hkv, S, hd),
    written in place at ``pos``.  Returns (out, new_cache)."""
    B, Sq, _ = x.shape
    scale = head_dim**-0.5
    q = _split_heads(p.wq(x), n_heads, head_dim)
    src = x if x_kv is None else x_kv
    k = _split_heads(p.wk(src), n_kv_heads, head_dim)
    v = _split_heads(p.wv(src), n_kv_heads, head_dim)

    if cos is not None and mode != "cross":
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)

    new_cache = None
    if mode == "decode":
        ck = _dus_seq(cache["k"], k, pos, 2)
        cv = _dus_seq(cache["v"], v, pos, 2)
        new_cache = {"k": ck, "v": cv}
        Skv = ck.shape[2]
        mask = (torch.arange(Skv, device=x.device) <= int(pos))[None, None, None, :]
        o = _sdpa(q, ck, cv, scale=scale, mask=mask.expand(B, 1, 1, Skv))
    elif mode == "cross_decode":
        # decoder cross-attention during decode: static encoder memory cache
        o = _sdpa(q, cache["k"], cache["v"], scale=scale, mask=None)
        new_cache = cache
    else:
        if use_flash:
            o = flash_attention(q, k, v, causal=(mode == "causal"), scale=scale)
        elif Sq > ATTN_CHUNK_THRESHOLD:
            o = _sdpa_chunked(q, k, v, scale=scale, causal=(mode == "causal"))
        else:
            mask = causal_mask(Sq, k.shape[2], device=x.device) if mode == "causal" else None
            o = _sdpa(q, k, v, scale=scale, mask=mask)
        if mode != "cross":
            new_cache = {"k": k, "v": v}  # prefill cache
    return p.wo(_merge_heads(o)), new_cache


# =========================================================== MLA attention
class MLAttention(nn.Module):
    """The projections of one MLA block, each (in, out): wq (D, H * (nope +
    rope)), the latent's down projection wdkv (D, kv_lora), the shared rope
    key wkrope (D, rope), the latent's up projections wuk (kv_lora, H *
    nope) and wuv (kv_lora, H * v_dim), and wo (H * v_dim, D)."""

    def __init__(self, d_model, n_heads, *, kv_lora, qk_nope_dim=128, qk_rope_dim=64,
                 v_dim=128, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d_model, n_heads * (qk_nope_dim + qk_rope_dim), **kw)
        self.wdkv = Dense(d_model, kv_lora, **kw)
        self.wkrope = Dense(d_model, qk_rope_dim, **kw)
        self.wuk = Dense(kv_lora, n_heads * qk_nope_dim, **kw)
        self.wuv = Dense(kv_lora, n_heads * v_dim, **kw)
        self.wo = Dense(n_heads * v_dim, d_model, **kw)

    def reset(self, generator: torch.Generator | None) -> None:
        for m in (self.wq, self.wdkv, self.wkrope, self.wuk, self.wuv, self.wo):
            m.reset(generator)


def mla_init(d_model, n_heads, *, kv_lora, qk_nope_dim=128, qk_rope_dim=64, v_dim=128,
             dtype, device, generator: torch.Generator | None = None) -> MLAttention:
    p = MLAttention(d_model, n_heads, kv_lora=kv_lora, qk_nope_dim=qk_nope_dim,
                    qk_rope_dim=qk_rope_dim, v_dim=v_dim, dtype=dtype, device=device)
    p.reset(generator)
    return p


def mla_apply(
    p: MLAttention, x, *, n_heads, kv_lora, qk_nope_dim=128, qk_rope_dim=64, v_dim=128,
    cos=None, sin=None, mode="causal", cache=None, pos=None,
):
    """mode: 'causal' | 'full' | 'decode'.  The rope turns only the last
    ``qk_rope_dim`` columns of each query head and the one shared key
    head ``kr``; the scale is (nope + rope)**-0.5.

    decode: x is (B, 1, D); cache = {'c': (B, S, kv_lora), 'kr': (B, S,
    rope)} preallocated, written in place at ``pos``.  Returns (out,
    new_cache), the prefill's cache being this layer's c and kr."""
    B, Sq, _ = x.shape
    qk_dim = qk_nope_dim + qk_rope_dim
    scale = qk_dim**-0.5

    q = _split_heads(p.wq(x), n_heads, qk_dim)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = rope_apply(q_rope, cos, sin)

    c_new = p.wdkv(x)                                        # (B, Sq, lora)
    kr_new = rope_apply(p.wkrope(x)[:, None], cos, sin)[:, 0]  # one shared rope head

    wuk = p.wuk.w.view(kv_lora, n_heads, qk_nope_dim)
    wuv = p.wuv.w.view(kv_lora, n_heads, v_dim)

    if mode == "decode":
        c = _dus_seq(cache["c"], c_new, pos, 1)
        kr = _dus_seq(cache["kr"], kr_new, pos, 1)
        new_cache = {"c": c, "kr": kr}
        # the absorbed form: q_nope into the latent space, scored against c
        # directly.  Each product runs in the operands' dtype (bf16 GEMMs
        # accumulate in float32) and only its small output is upcast: a
        # cast of c, kr or the up projections would copy them every step
        acc = acc_dtype(x.dtype)
        q_lat = torch.einsum("bhqd,lhd->bhql", q_nope, wuk)
        s_lat = torch.einsum("bhql,bkl->bhqk", q_lat.to(c.dtype), c).to(acc)
        s_rope = torch.einsum("bhqd,bkd->bhqk", q_rope.to(kr.dtype), kr).to(acc)
        s_all = (s_lat + s_rope) * scale
        mask = torch.arange(c.shape[1], device=x.device) <= int(pos)
        prob = torch.softmax(torch.where(mask, s_all, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhqk,bkl->bhql", prob.to(c.dtype), c)
        o = torch.einsum("bhql,lhd->bhqd", o_lat.to(wuv.dtype), wuv).to(x.dtype)
    else:
        new_cache = {"c": c_new, "kr": kr_new}
        k_nope = torch.einsum("bkl,lhd->bhkd", c_new, wuk)   # expanded per head
        vfull = torch.einsum("bkl,lhd->bhkd", c_new, wuv)
        k = torch.cat([k_nope, kr_new[:, None].expand(B, n_heads, Sq, qk_rope_dim)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        if Sq > ATTN_CHUNK_THRESHOLD:
            o = _sdpa_chunked(qfull, k, vfull, scale=scale, causal=(mode == "causal"))
        else:
            mask = causal_mask(Sq, Sq, device=x.device) if mode == "causal" else None
            o = _sdpa(qfull, k, vfull, scale=scale, mask=mask)
    return p.wo(_merge_heads(o)), new_cache
