"""The decoder family: dense-MLP GQA decoder stacks, as ``nn.Module``s.

    prefill(net, batch)                      -> (last_logits, caches)
    decode_step(net, token, caches, pos)     -> (logits, caches)

A ``DecoderLM`` holds the embedding, an ``nn.ModuleList`` of
``DecoderLayer``s, the final norm and the LM head; a Python loop over the
layers replaces the reference's ``lax.scan``.  KV caches keep the
reference's layout, stacked on a leading layer axis:
``{"k": (L, B, Hkv, S, hd), "v": ...}``.  Prefill allocates them once at a
``capacity`` (the prompt length by default; ``greedy_generate`` asks for
prompt + new tokens) with zeros past the prompt, and each decode step
writes its position in place.

Vocab is padded to a multiple of 256, as in the reference; padded rows are
ordinary parameters that real tokens never select.

Prefill runs self-attention through the ``flash_attention`` kernel on the
card (``use_flash``, the reference's ``gqa_apply`` argument that its
``attention.py`` says the kernel replaces the dense path with); on the CPU
it takes the reference's own dense or chunked paths.  The reference's
``distributed.context.constrain`` is the identity without a mesh and is
dropped.

Dense GQA configs run (qwen2.5-3b, qwen2-72b, granite-3-8b,
internlm2-20b); the MoE, MLA, rwkv, hybrid, encoder-decoder and frontend
families raise ``NotImplementedError``: they are later slices of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import GQAttention, gqa_apply
from repro_torch.models.layers import Dense, Embedding, RMSNorm, SwiGLU, rope_angles

VOCAB_PAD = 256

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def padded_vocab(cfg: ArchConfig) -> int:
    return ((cfg.vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, naming the slice that brings it (ROADMAP queue 1, the LM
    pillar)."""
    for unported, slice_name in (
        (cfg.moe, "the MoE slice (models/moe.py)"),
        (cfg.mla, "the MLA slice (mla_init / mla_apply)"),
        (cfg.ssm, "the rwkv slice (models/ssm.py)"),
        (cfg.hybrid, "the hybrid (zamba2) slice"),
        (cfg.encoder_decoder, "the encoder-decoder slice"),
        (cfg.frontend, "the frontend slice"),
    ):
        if unported:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): not ported yet; it comes with "
                f"{slice_name} of the LM pillar (ROADMAP queue 1)"
            )


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + swiglu(ln2(x))."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = GQAttention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, bias=cfg.qkv_bias, **kw)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def reset(self, generator: torch.Generator | None) -> None:
        self.ln1.reset()
        self.ln2.reset()
        self.attn.reset(generator)
        self.mlp.reset(generator)

    def forward(self, x, *, cos, sin, mode, cache=None, pos=None, use_flash=False):
        cfg = self.cfg
        h, new_cache = gqa_apply(
            self.attn, self.ln1(x), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, cos=cos, sin=sin, mode=mode,
            cache=cache, pos=pos, use_flash=use_flash,
        )
        x = x + h
        return x + self.mlp(self.ln2(x)), new_cache


class DecoderLM(nn.Module):
    """Embedding, decoder layers, final norm and LM head of one config, its
    parameters in ``cfg.dtype`` on ``device`` (left uninitialised until
    ``init_params``; ``device="meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu"):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=TORCH_DTYPES[cfg.dtype], device=torch.device(device))
        self.cfg = cfg
        vocab = padded_vocab(cfg)
        self.embed = Embedding(vocab, cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.lm_head = Dense(cfg.d_model, vocab, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_params(self, seed: int = 0) -> None:
        """Draw every parameter in place on its device from one generator
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.reset(gen)
        self.final_norm.reset()
        self.lm_head.reset(gen)
        for layer in self.layers:
            layer.reset(gen)


def _rope_cache(cfg: ArchConfig, positions: torch.Tensor):
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _embed_sequence(net: DecoderLM, batch: dict) -> torch.Tensor:
    return net.embed(batch["tokens"])


def _run_decoder_stack(net: DecoderLM, x, *, mode, caches=None, pos=None,
                       use_flash=False, capacity=None):
    cfg = net.cfg
    B, S, _ = x.shape
    if mode == "decode":
        # filled on the device: a tensor built from a host list would be a
        # pageable copy, which waits for the device at every decode step
        positions = torch.full((1,), int(pos), device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    cos, sin = _rope_cache(cfg, positions)

    if mode == "decode":
        for i, layer in enumerate(net.layers):
            x, _ = layer(x, cos=cos, sin=sin, mode="decode",
                         cache={"k": caches["k"][i], "v": caches["v"][i]}, pos=pos)
        return x, caches

    cap = S if capacity is None else max(int(capacity), S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, cap, cfg.resolved_head_dim)
    caches = {name: torch.zeros(shape, dtype=x.dtype, device=x.device) for name in ("k", "v")}
    for i, layer in enumerate(net.layers):
        x, cache = layer(x, cos=cos, sin=sin, mode=mode, use_flash=use_flash)
        for name in ("k", "v"):
            caches[name][i, :, :, :S].copy_(cache[name])
    return x, caches


def backbone_apply(net: DecoderLM, batch: dict, *, mode, caches=None, pos=None,
                   use_flash=False, capacity=None):
    """The decoder stack over the batch's tokens; returns (hidden,
    caches)."""
    x = _embed_sequence(net, batch)
    return _run_decoder_stack(net, x, mode=mode, caches=caches, pos=pos,
                              use_flash=use_flash, capacity=capacity)


def prefill(net: DecoderLM, batch: dict, *, capacity=None, use_flash=None):
    """Logits of the last position, (B, padded vocab), and the KV caches
    (capacity positions, the prompt's written).  ``use_flash=None`` is the
    device's choice: the kernel on the card, the reference's paths on the
    CPU; ``False`` forces the reference's dense path (a check's oracle)."""
    if use_flash is None:
        use_flash = net.device.type == "cuda"
    x, caches = backbone_apply(net, batch, mode="causal", use_flash=use_flash,
                               capacity=capacity)
    x = net.final_norm(x[:, -1:])
    return net.lm_head(x)[:, 0], caches


def decode_step(net: DecoderLM, token: torch.Tensor, caches: dict, pos):
    """token: (B, 1) int; pos: the write index.  The caches are written in
    place and returned."""
    x, caches = backbone_apply(net, {"tokens": token}, mode="decode", caches=caches, pos=pos)
    x = net.final_norm(x)
    return net.lm_head(x)[:, 0], caches
