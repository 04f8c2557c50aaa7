"""RWKV6-7B (Finch): attention-free, data-dependent decay
[arXiv:2404.05892].  32L d_model=4096 d_ff=14336 vocab=65536.
SSM => O(1) decode state => runs the long_500k cell."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,         # d_model / ssm_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    ssm=True,
    ssm_head_dim=64,
    ssm_lora_rank=64,
    sub_quadratic=True,
)
