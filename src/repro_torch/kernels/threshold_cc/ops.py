"""Public wrappers for the hook step (the CUDA kernel on the card, the plain
version on the CPU) and the connected-components loop around it.

``labelprop_rows`` is the step over a row slab of S (the sharded screen,
``core.distributed.distributed_components``, runs it once a round on each
device's own rows); ``labelprop_step`` is its square case, row0 = 0 and
every row, through the same launch."""

from __future__ import annotations

import torch

from repro_torch.core.components import propagate_labels
from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.threshold_cc.ref import labelprop_rows_ref, labelprop_step_ref

#: dtype codes of ``threshold_cc_rows_launch``
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _launch(S_rows: torch.Tensor, labels: torch.Tensor, lam: float, row0: int) -> torch.Tensor:
    """One launch of ``csrc/threshold_cc.cu`` over the (rows, pp) slab of
    rows [row0, row0 + rows); checks what the kernel takes and raises."""
    if S_rows.device.type != "cuda":
        raise ValueError(f"threshold_cc: no kernel for device {S_rows.device}")
    if S_rows.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"threshold_cc: the CUDA kernel takes float32 or float64, got {S_rows.dtype}"
        )
    if S_rows.ndim != 2:
        raise ValueError(f"threshold_cc: S must be 2-D, got {tuple(S_rows.shape)}")
    rows, pp = S_rows.shape
    if not 0 <= row0 <= pp - rows:
        raise ValueError(f"threshold_cc: rows [{row0}, {row0 + rows}) outside 0 .. {pp}")
    if labels.shape != (pp,) or labels.dtype != torch.int32 or labels.device != S_rows.device:
        raise ValueError(
            f"threshold_cc: labels must be ({pp},) int32 on {S_rows.device}, got "
            f"{tuple(labels.shape)} {labels.dtype} on {labels.device}"
        )
    S_rows, labels = S_rows.contiguous(), labels.contiguous()
    out = torch.empty(rows, dtype=torch.int32, device=S_rows.device)
    if rows == 0:
        return out
    with torch.cuda.device(S_rows.device):
        status = library().threshold_cc_rows_launch(
            S_rows.data_ptr(), labels.data_ptr(), out.data_ptr(), rows, pp, row0,
            float(lam), _DTYPE_CODE[S_rows.dtype], torch.cuda.current_stream().cuda_stream,
        )
    check(status, "threshold_cc")
    bump("kernels.threshold_cc.launches")
    return out


def labelprop_step(S: torch.Tensor, labels: torch.Tensor, lam: float) -> torch.Tensor:
    """One fused threshold + hook step over a (p, p) S and (p,) int32
    labels, in S's own dtype.

    A CPU S runs the plain version; a CUDA S launches
    ``csrc/threshold_cc.cu`` (float32 or float64) over all of its rows or
    raises.  Each launch bumps ``kernels.threshold_cc.launches``."""
    if S.device.type == "cpu":
        return labelprop_step_ref(S, labels, lam)
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(f"threshold_cc: S must be (p, p), got {tuple(S.shape)}")
    return _launch(S, labels, lam, 0)


def labelprop_rows(
    S_rows: torch.Tensor, labels: torch.Tensor, lam: float, row0: int
) -> torch.Tensor:
    """The hook step of S's rows [row0, row0 + rows), given as the (rows,
    pp) slab ``S_rows`` on its device, against the full (pp,) int32
    ``labels`` there: the slab's new labels, (rows,) int32.  The diagonal
    is masked by global row.

    A CPU slab runs the plain version; a CUDA slab launches
    ``csrc/threshold_cc.cu`` or raises.  Each launch bumps
    ``kernels.threshold_cc.launches``."""
    if S_rows.device.type == "cpu":
        return labelprop_rows_ref(S_rows, labels, lam, row0)
    return _launch(S_rows, labels, lam, int(row0))


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
