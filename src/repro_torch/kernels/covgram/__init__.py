"""Tiled centered Gram matrix S = (X - mu)'(X - mu)/n of an (n, p) data
matrix, float32 out: the large-scale pipeline's covariance front end."""

from repro_torch.kernels.covgram.ops import covgram
from repro_torch.kernels.covgram.ref import covgram_ref

__all__ = ["covgram", "covgram_ref"]
