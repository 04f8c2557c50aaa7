"""Blockwise online-softmax attention (causal or full, GQA) for the LM
serving path's prefill, float32 or bf16."""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
