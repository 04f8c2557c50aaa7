"""Serving helpers: the prefill -> decode cache hand-off and a batched
greedy-decode loop."""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import cache_seq_axis


def _pad_axis(a: torch.Tensor, axis: int, to_len: int) -> torch.Tensor:
    cur = a.shape[axis]
    if cur >= to_len:
        return a
    shape = list(a.shape)
    shape[axis] = to_len
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    out.narrow(axis, 0, cur).copy_(a)
    return out


def pad_caches(cfg: ArchConfig, caches: dict, cur_len: int, *, to_len: int) -> dict:
    """Grow prefill caches to a decode capacity along their seq axis, zeros
    past the prefix.  The layouts, stacked on the layer axis: GQA's k/v
    (L, B, Hkv, S, hd), seq axis 3; MLA's c (L, B, S, kv_lora) and kr
    (L, B, S, rope), seq axis 2.  Caches already that long (a prefill
    given ``capacity``) are returned as they are."""
    axis = cache_seq_axis(cfg)
    return {name: _pad_axis(a, axis, to_len) for name, a in caches.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model, batch: dict, *, max_new_tokens: int, stats: dict | None = None):
    """Prefill, then greedy decode: returns (B, max_new_tokens) int32 token
    ids.  The caches are allocated once, at prompt + new tokens, by the
    prefill (the reference pads them with ``pad_caches`` after a prefill at
    the prompt's length: the same values).  ``stats``, when given, receives
    the prefill and decode seconds (the device synchronised at each
    boundary) and the count of decode steps."""
    cfg = model.cfg
    dev = model.device
    prompt_len = batch["tokens"].shape[1]
    total = prompt_len + max_new_tokens
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, capacity=total)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
    tokens = []
    offset = cfg.frontend_len if cfg.frontend else 0
    for i in range(max_new_tokens):
        tokens.append(tok)
        logits, caches = model.decode_step(tok, caches, prompt_len + i + offset)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = torch.cat(tokens, dim=1)
    if stats is not None:
        _sync(dev)
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     decode_steps=max_new_tokens)
    return out
