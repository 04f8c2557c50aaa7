"""The joint ADMM's Z-update in one pass: the K-way group or fused prox,
the dual update and both residual partials over a bucket of lanes."""

from repro_torch.kernels.joint_prox.ops import MAX_CLASSES, joint_prox_step
from repro_torch.kernels.joint_prox.ref import (
    PENALTIES,
    fused_prox,
    group_prox,
    joint_prox_entries,
    joint_prox_ref,
    tv_complete_prox,
)

__all__ = [
    "MAX_CLASSES",
    "PENALTIES",
    "joint_prox_step",
    "joint_prox_ref",
    "joint_prox_entries",
    "group_prox",
    "fused_prox",
    "tv_complete_prox",
]
