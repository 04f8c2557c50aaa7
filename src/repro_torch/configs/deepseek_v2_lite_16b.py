"""DeepSeek-V2-Lite (16B): MLA attention (kv_lora=512) + fine-grained MoE
with 2 shared + 64 routed experts, top-6 [arXiv:2405.04434].
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.
(The assignment line reads "MoE 64e top-6"; the full V2 has 160 routed
experts — Lite has 64, which is what we build.  See DESIGN.md.)"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
