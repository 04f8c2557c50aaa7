"""The ADMM solvers' fused prox tail: soft-threshold, dual update and both
residual partials in one pass."""

from repro_torch.kernels.shard_prox.ops import fused_prox_residual
from repro_torch.kernels.shard_prox.ref import fused_prox_ref

__all__ = ["fused_prox_residual", "fused_prox_ref"]
