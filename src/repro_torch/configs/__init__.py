"""Architecture configs (one module per architecture, the same dimensions as
the reference package's) and the shape registry."""

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeConfig, get_arch, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "list_archs"]
