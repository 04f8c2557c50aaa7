"""Public wrapper for the hook step (the CUDA kernel on the card, the plain
version on the CPU) and the connected-components loop around it."""

from __future__ import annotations

import torch

from repro_torch.core.components import propagate_labels
from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.threshold_cc.ref import labelprop_step_ref

#: dtype codes of ``threshold_cc_step_launch``
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def labelprop_step(S: torch.Tensor, labels: torch.Tensor, lam: float) -> torch.Tensor:
    """One fused threshold + hook step over a (p, p) S and (p,) int32
    labels, in S's own dtype.

    A CPU S runs the plain version; a CUDA S launches
    ``csrc/threshold_cc.cu`` (float32 or float64) or raises.  Each launch
    bumps ``kernels.threshold_cc.launches``."""
    if S.device.type == "cpu":
        return labelprop_step_ref(S, labels, lam)
    if S.device.type != "cuda":
        raise ValueError(f"threshold_cc: no kernel for device {S.device}")
    if S.dtype not in _DTYPE_CODE:
        raise TypeError(f"threshold_cc: the CUDA kernel takes float32 or float64, got {S.dtype}")
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(f"threshold_cc: S must be (p, p), got {tuple(S.shape)}")
    p = S.shape[0]
    if labels.shape != (p,) or labels.dtype != torch.int32 or labels.device != S.device:
        raise ValueError(
            f"threshold_cc: labels must be ({p},) int32 on {S.device}, got "
            f"{tuple(labels.shape)} {labels.dtype} on {labels.device}"
        )
    S, labels = S.contiguous(), labels.contiguous()
    out = torch.empty_like(labels)
    if p == 0:
        return out
    with torch.cuda.device(S.device):
        status = library().threshold_cc_step_launch(
            S.data_ptr(), labels.data_ptr(), out.data_ptr(), p, float(lam),
            _DTYPE_CODE[S.dtype], torch.cuda.current_stream().cuda_stream,
        )
    check(status, "threshold_cc")
    bump("kernels.threshold_cc.launches")
    return out


def connected_components_kernel(S: torch.Tensor, lam: float) -> torch.Tensor:
    """Connected-component labels of |S_ij| > lam (i != j) through the hook
    step and pointer jumping, to a fixed point (at most p + 2 rounds, as the
    reference's ``connected_components_kernel``).  Returns int32 labels on
    S's device; bumps ``screen.labelprop_rounds`` by the rounds run."""
    labels, rounds = propagate_labels(
        lambda lab: labelprop_step(S, lab, lam), S.shape[0], device=S.device
    )
    bump("screen.labelprop_rounds", rounds)
    return labels
