"""InternVL2-26B: InternViT frontend (stubbed) + InternLM2-20B-class LM
backbone [arXiv:2404.16821].  48L d_model=6144 48H GQA(kv=8) d_ff=16384
vocab=92553.  The ViT is a modality stub: input_specs() supplies precomputed
patch embeddings prepended to the token stream."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="patch",
    frontend_len=256,
)
