"""Qwen3-30B-A3B: MoE decoder, 128 routed experts top-8, GQA kv=4
[hf:Qwen/Qwen3-30B-A3B].  48L d_model=2048 32H d_ff(expert)=768
vocab=151936."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    moe=True,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    n_shared_experts=0,
)
