"""Fused centered-Gram + threshold + edge-emit over scheduled tile pairs:
the streaming screener's kernel (the dense (p, p) S never exists)."""

from repro_torch.kernels.covgram_screen.ops import (
    compact_edges,
    compact_edges_signed,
    covgram_screen_tiles,
    covgram_screen_tiles_stacked,
    pad_for_screen,
)
from repro_torch.kernels.covgram_screen.ref import covgram_screen_ref

__all__ = [
    "covgram_screen_tiles",
    "covgram_screen_tiles_stacked",
    "covgram_screen_ref",
    "compact_edges",
    "compact_edges_signed",
    "pad_for_screen",
]
