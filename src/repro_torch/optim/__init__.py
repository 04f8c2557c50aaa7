"""Hand-rolled optimizers, as in the reference (it has no optax either)."""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_with_warmup

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}

__all__ = ["adamw", "adafactor", "cosine_with_warmup", "OPTIMIZERS"]
