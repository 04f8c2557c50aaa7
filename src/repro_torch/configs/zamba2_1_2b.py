"""Zamba2-1.2B: Mamba2 backbone + shared full-attention block
[arXiv:2411.15242].  38 mamba layers, d_model=2048, shared attn 32H (MHA
kv=32) + shared MLP d_ff=8192, ssm_state=64, vocab=32000.  Hybrid =>
sub-quadratic => runs the long_500k cell."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    hybrid=True,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    sub_quadratic=True,
)
