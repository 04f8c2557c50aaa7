"""The screen on the device: the fused threshold + min-label hook step of
connected components, driven to a fixed point."""

from repro_torch.kernels.threshold_cc.ops import connected_components_kernel, labelprop_step
from repro_torch.kernels.threshold_cc.ref import labelprop_step_ref

__all__ = ["connected_components_kernel", "labelprop_step", "labelprop_step_ref"]
