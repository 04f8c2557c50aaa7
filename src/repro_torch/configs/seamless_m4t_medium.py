"""SeamlessM4T-medium: encoder-decoder, speech frontend stubbed
[arXiv:2308.11596].  12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.  The encoder consumes precomputed frame embeddings
(input_specs() stub); shapes' seq_len applies to the decoder stream."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    encoder_decoder=True,
    n_enc_layers=12,
    enc_len=4096,
    frontend="frames",
)
