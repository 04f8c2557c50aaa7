"""The screen on the device: the fused threshold + min-label hook step of
connected components (over all of S, or a row slab of it for the sharded
screen), driven to a fixed point."""

from repro_torch.kernels.threshold_cc.ops import (
    connected_components_kernel,
    labelprop_rows,
    labelprop_step,
)
from repro_torch.kernels.threshold_cc.ref import labelprop_rows_ref, labelprop_step_ref

__all__ = [
    "connected_components_kernel",
    "labelprop_rows",
    "labelprop_rows_ref",
    "labelprop_step",
    "labelprop_step_ref",
]
