"""Core of the port: screening, blocks, solvers and the ``glasso`` entry."""

from repro_torch.core.glasso import EngineOptions, GlassoResult, glasso, glasso_path

__all__ = ["EngineOptions", "GlassoResult", "glasso", "glasso_path"]
