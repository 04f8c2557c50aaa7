"""Config dataclasses + the arch/shape registries.

Every assigned architecture gets one module (src/repro_torch/configs/<id>.py)
exporting CONFIG with the exact assigned dimensions; ``reduced()`` shrinks
any config to a CPU-smoke-test size of the same family.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # --- MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1             # every k-th layer is MoE
    # --- MLA
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid
    ssm: bool = False              # rwkv-style attention-free
    hybrid: bool = False           # mamba backbone + shared attention
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_lora_rank: int = 64
    attn_every: int = 6            # hybrid: shared attn after every k ssm layers
    # --- encoder-decoder
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_len: int = 4096            # stub frontend frames fed to the encoder
    # --- modality stub frontend
    frontend: str | None = None    # None | "patch" | "frames"
    frontend_len: int = 256        # embeddings prepended to the token stream
    # --- numerics
    dtype: str = "bfloat16"
    sub_quadratic: bool = False    # may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        r = {
            "n_layers": min(self.n_layers, 2),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            "head_dim": 16,
            "d_ff": 128,
            "vocab": 256,
        }
        if self.moe:
            r.update(n_experts=4, top_k=2, d_ff_expert=32,
                     n_shared_experts=min(self.n_shared_experts, 1))
        if self.mla:
            r.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.ssm or self.hybrid:
            r.update(ssm_state=8, ssm_head_dim=8, ssm_chunk=8, ssm_lora_rank=8,
                     attn_every=2)
            if self.hybrid:
                r.update(n_layers=4)  # 2 segments -> shared attn exercised
            if self.ssm:
                r.update(d_model=64, n_heads=8, head_dim=8)  # rwkv: H = D/hd
        if self.encoder_decoder:
            r.update(n_enc_layers=2, enc_len=16)
        if self.frontend:
            r.update(frontend_len=4)
        return replace(self, **r)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "internvl2_26b",
    "granite_3_8b",
    "internlm2_20b",
    "qwen2_72b",
    "qwen2_5_3b",
    "deepseek_v2_lite_16b",
    "qwen3_moe_30b_a3b",
    "zamba2_1_2b",
    "rwkv6_7b",
    "seamless_m4t_medium",
]


def get_arch(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell; reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attention arch)"
    return True, ""
