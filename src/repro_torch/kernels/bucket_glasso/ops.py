"""Public wrapper for the fused bucket BCD: the CUDA kernel on the card,
the plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.bucket_glasso.ref import fused_bcd_ref_stack
from repro_torch.kernels.build import check, check_operands, instance, library


def layout(b: int, dtype: torch.dtype) -> tuple[int, int]:
    """(shared-memory bytes, device scratch values) of one lane of the CUDA
    kernel at size b: 0 scratch values when its four (b, b) tiles fit
    shared memory, 2 b^2 when W alone does, 3 b^2 when W goes to device
    scratch too (``csrc/bucket_glasso.cu``: ``smem_bytes``,
    ``scratch_values``)."""
    lib = library()
    return (lib.bucket_glasso_smem_bytes(b, dtype.itemsize),
            lib.bucket_glasso_scratch_values(b, dtype.itemsize))


def fused_bcd_stack(
    blocks: torch.Tensor,
    lams: torch.Tensor,
    scales: torch.Tensor,
    W0: torch.Tensor,
    T0: torch.Tensor,
    *,
    max_sweeps: int = 100,
    n_cd: int = 100,
    tol: float = 1e-6,
    node_screen: bool = True,
    cd_sweeps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve every lane of a (N, b, b) stack; returns (Theta, sweeps (N,)
    int32).  ``cd_sweeps``, when given, is an (N,) int64 tensor on the
    stack's device that receives each lane's total count of inner
    coordinate-descent sweeps (the length of its serial chain over b).

    ``lams``/``scales`` are per lane, shape (N,); every lane carries its
    (W0, T0) warm pair (cold lanes: S + lam*I and I).  A CPU stack runs the
    plain version; a CUDA stack launches ``csrc/bucket_glasso.cu`` (its
    float64 or float32 instance, any b) or raises.  Each launch bumps ``kernels.bucket_glasso.launches``."""
    opts = dict(max_sweeps=max_sweeps, n_cd=n_cd, tol=tol, node_screen=node_screen)
    if blocks.device.type == "cpu":
        return fused_bcd_ref_stack(
            blocks, lams, scales, W0, T0, cd_sweeps=cd_sweeps, **opts
        )
    N, b = check_operands("bucket_glasso", blocks, lams, scales)
    if W0.shape != blocks.shape or T0.shape != blocks.shape:
        raise ValueError(
            f"bucket_glasso: W0 {tuple(W0.shape)} and T0 {tuple(T0.shape)} "
            f"must match blocks {tuple(blocks.shape)}"
        )
    check_operands("bucket_glasso", W0)
    check_operands("bucket_glasso", T0)
    if W0.dtype != blocks.dtype or T0.dtype != blocks.dtype:
        raise TypeError(
            f"bucket_glasso: W0 {W0.dtype} and T0 {T0.dtype} must match blocks {blocks.dtype}"
        )
    if cd_sweeps is not None and (
        cd_sweeps.shape != (N,) or cd_sweeps.dtype != torch.int64
        or cd_sweeps.device != blocks.device or not cd_sweeps.is_contiguous()
    ):
        raise ValueError(
            f"bucket_glasso: cd_sweeps must be a contiguous ({N},) int64 "
            f"tensor on {blocks.device}"
        )
    blocks, W0, T0 = blocks.contiguous(), W0.contiguous(), T0.contiguous()
    lams, scales = lams.contiguous(), scales.contiguous()
    theta = torch.empty_like(blocks)
    sweeps = torch.empty(N, dtype=torch.int32, device=blocks.device)
    if N == 0:
        return theta, sweeps
    lib = library()
    values = layout(b, blocks.dtype)[1]
    scratch = (
        torch.empty(N * values, dtype=blocks.dtype, device=blocks.device)
        if values
        else theta  # unused by the kernel when the tiles fit shared memory
    )
    with torch.cuda.device(blocks.device):
        launch = getattr(lib, f"bucket_glasso_launch_{instance('bucket_glasso', blocks.dtype)}")
        status = launch(
            blocks.data_ptr(), lams.data_ptr(), scales.data_ptr(),
            W0.data_ptr(), T0.data_ptr(), theta.data_ptr(), sweeps.data_ptr(),
            None if cd_sweeps is None else cd_sweeps.data_ptr(),
            scratch.data_ptr(), N, b, int(max_sweeps), int(n_cd), float(tol),
            int(bool(node_screen)), torch.cuda.current_stream().cuda_stream,
        )
    check(status, "bucket_glasso")
    bump("kernels.bucket_glasso.launches")
    return theta, sweeps
