"""Whole-solve BCD over a bucket stack in one launch: outer sweeps, inner
lasso CD, eq.-(10) node screening and per-lane convergence all run inside
the kernel, so a converged lane stops without waiting for the others."""

from repro_torch.kernels.bucket_glasso.ops import fused_bcd_stack
from repro_torch.kernels.bucket_glasso.ref import fused_bcd_ref_stack, fused_bcd_single

__all__ = ["fused_bcd_stack", "fused_bcd_ref_stack", "fused_bcd_single"]
