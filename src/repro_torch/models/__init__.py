"""The LM substrate's models: dense GQA decoder stacks, their layers and
attention, and `build_model`."""

from repro_torch.models.zoo import build_model

__all__ = ["build_model"]
