"""The ``pg`` solver's proximal-gradient step soft(theta - t*grad, t*lam)."""

from repro_torch.kernels.prox_l1.ops import prox_step
from repro_torch.kernels.prox_l1.ref import prox_step_ref

__all__ = ["prox_step", "prox_step_ref"]
