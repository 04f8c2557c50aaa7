"""Plain PyTorch version of the fused bucket BCD: ``glasso_bcd`` per lane.

``fused_bcd_ref_stack`` solves every lane of a (N, b, b) stack by GLASSO
block coordinate descent [Friedman, Hastie, Tibshirani 2007] from an
injected warm pair and convergence scale, with the reference package's loop
semantics (``repro.kernels.bucket_glasso.ref.fused_bcd_single``):

* W starts as W0 with the diagonal set to S_ii + lam (exact at the
  solution); the inner-lasso coefficients start as B = -T0 / diag(T0)
  column-wise off the diagonal.  A cold lane passes W0 = S + lam*I and
  T0 = I.
* One outer sweep updates every column j in order (Gauss-Seidel), using
  the W from before column j's update.  The eq.-(10) node screen
  max_k!=j |S_kj| <= lam sets beta_j = 0; otherwise the inner lasso runs
  cyclic coordinate descent from B[:, j] — one sweep always, then more
  while the sweep's largest update exceeds tol*scale and fewer than n_cd
  ran.  The outer loop likewise runs one sweep always, then more while
  max|W - W_old| over the sweep exceeds tol*scale and fewer than
  max_sweeps ran.
* Theta is recovered per column, theta_22 = 1/(w_22 - w12' beta),
  theta_12 = -beta theta_22, then symmetrized 0.5 (Theta + Theta^T).

Lanes run batched: every loop carries only the lanes still iterating, so
each lane's result and sweep count are those of its own solve.

Every dot product over a lane's row or column runs over at least
``SUM_WIDTH`` terms, the real ones first and exact zeros after them
(``_pad``), so a lane's bits do not depend on the stack's size: torch
orders a reduction by its length, and a block of b <= ``SUM_WIDTH``
re-padded with an identity diagonal (as the wave packer does,
``engine.waves.repad_stack``) reduces the same vectors of the same length
and keeps every value and sweep count.  The sums stay in the stack's dtype.
"""

from __future__ import annotations

import torch


#: the least length of every dot product: the largest wave-packer bin
#: (``engine.waves.FUSED_BINS``)
SUM_WIDTH = 64


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``width``, contiguous: the
    order of a sum over the last dim depends on its layout too."""
    n = x.shape[-1]
    return x.contiguous() if n >= width else torch.nn.functional.pad(x, (0, width - n))


def _lasso_cd(
    W: torch.Tensor, s12: torch.Tensor, lam: torch.Tensor, beta: torch.Tensor,
    j: int, thr: torch.Tensor, n_cd: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cyclic coordinate descent for eq. (9) on column j of every lane;
    ``beta`` (lanes, b) holds the start with beta[:, j] == 0.  Returns
    (beta, sweeps run per lane).

    Per coordinate: beta_k <- soft(s12_k - sum_{l != k} W_kl beta_l, lam)
    / W_kk with soft(r, t) = sign(r) max(|r| - t, 0), computed as
    r - clamp(r, -t, t) (the same value).  Each coordinate changes once per
    sweep, so the sweep's largest update is max_k |beta_end - beta_start|."""
    b = beta.shape[1]
    # the rows of W and beta padded to SUM_WIDTH once, so each update's
    # dot product has the same length at every b up to it
    width = max(b, SUM_WIDTH)
    W, beta = _pad(W, width), _pad(beta, width).clone()
    runs = torch.zeros(beta.shape[0], dtype=torch.int64, device=beta.device)
    live = torch.arange(beta.shape[0], device=beta.device)
    it = 0
    while True:
        Wl, laml, bl = W[live], lam[live], beta[live]
        rows, s_k = Wl.unbind(1), s12[live].unbind(1)
        wd = Wl.diagonal(dim1=1, dim2=2).unbind(1)
        start = bl.clone()
        for k in range(b):
            if k == j:
                bl[:, k] = 0.0
                continue
            r = s_k[k] - (torch.linalg.vecdot(rows[k], bl) - wd[k] * bl[:, k])
            bl[:, k] = (r - torch.clamp(r, -laml, laml)) / wd[k]
        beta[live] = bl
        runs[live] += 1
        it += 1
        keep = (bl - start).abs().amax(dim=1) > thr[live]
        if it >= n_cd or not bool(keep.any()):
            return beta[:, :b], runs
        live = live[keep]


def _sweep(
    S: torch.Tensor, lam: torch.Tensor, W: torch.Tensor, B: torch.Tensor,
    thr: torch.Tensor, n_cd: int, node_screen: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One outer sweep of every lane; returns (W, B, max|W - W_old|, inner
    sweeps run per lane)."""
    b = S.shape[1]
    width = max(b, SUM_WIDTH)
    W_old = W
    runs = torch.zeros(S.shape[0], dtype=torch.int64, device=S.device)
    W, B = W.clone(), B.clone()
    for j in range(b):
        s12 = S[:, :, j].clone()
        s12[:, j] = 0.0
        beta = B[:, :, j].clone()
        beta[:, j] = 0.0
        if node_screen:
            screened = s12.abs().amax(dim=1) <= lam
            solve = torch.nonzero(~screened)[:, 0]
            beta[screened] = 0.0
        else:
            solve = torch.arange(S.shape[0], device=S.device)
        if solve.numel():
            beta[solve], r = _lasso_cd(
                W[solve], s12[solve], lam[solve], beta[solve], j, thr[solve], n_cd
            )
            runs[solve] += r
        w12 = torch.linalg.vecdot(_pad(W, width), _pad(beta, width)[:, None, :])
        w12[:, j] = W[:, j, j]
        W[:, :, j] = w12
        W[:, j, :] = w12
        B[:, :, j] = beta
    return W, B, (W - W_old).abs().amax(dim=(1, 2)), runs


def fused_bcd_ref_stack(
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
    """Solve every lane of a (N, b, b) stack; returns (Theta (N, b, b),
    sweeps (N,) int32).  ``lams``/``scales`` are per lane, shape (N,);
    ``cd_sweeps``, when given, receives each lane's total count of inner
    coordinate-descent sweeps."""
    N, b, _ = blocks.shape
    S = blocks
    dev = S.device
    lam = lams.reshape(N).to(S.dtype)
    thr = tol * scales.reshape(N).to(S.dtype)
    eye = torch.eye(b, dtype=torch.bool, device=dev)
    W = torch.where(eye, (S.diagonal(dim1=1, dim2=2) + lam[:, None])[:, None, :], W0)
    d = T0.diagonal(dim1=1, dim2=2)
    d = torch.where(d > 0, d, torch.ones((), dtype=S.dtype, device=dev))
    B = torch.where(eye, 0.0, -(T0 / d[:, None, :]))
    sweeps = torch.zeros(N, dtype=torch.int32, device=dev)
    cd_total = torch.zeros(N, dtype=torch.int64, device=dev)

    live = torch.arange(N, device=dev)
    it = 0
    while N:
        Wl, Bl, delta, runs = _sweep(
            S[live], lam[live], W[live], B[live], thr[live], n_cd, node_screen
        )
        W[live], B[live] = Wl, Bl
        sweeps[live] += 1
        cd_total[live] += runs
        it += 1
        keep = delta > thr[live]
        if it >= max_sweeps or not bool(keep.any()):
            break
        live = live[keep]

    wd = W.diagonal(dim1=1, dim2=2)
    w12 = W.clone()
    w12.diagonal(dim1=1, dim2=2).zero_()
    width = max(b, SUM_WIDTH)
    t22 = 1.0 / (wd - torch.linalg.vecdot(_pad(w12.mT, width), _pad(B.mT, width)))
    Theta = -B * t22[:, None, :]
    Theta.diagonal(dim1=1, dim2=2).copy_(t22)
    if cd_sweeps is not None:
        cd_sweeps.copy_(cd_total)
    return 0.5 * (Theta + Theta.transpose(1, 2)), sweeps


def fused_bcd_single(
    S: torch.Tensor,
    lam,
    scale,
    W0: torch.Tensor,
    Theta0: torch.Tensor,
    **opts,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One (b, b) lane: returns (Theta, sweeps)."""
    dt, dev = S.dtype, S.device
    theta, sweeps = fused_bcd_ref_stack(
        S[None],
        torch.as_tensor(lam, dtype=dt, device=dev).reshape(1),
        torch.as_tensor(scale, dtype=dt, device=dev).reshape(1),
        W0[None],
        Theta0[None],
        **opts,
    )
    return theta[0], sweeps[0]
