"""Matmul-only ADMM for OVERSIZE blocks, on the row-sharded layout.

Every other solver runs one block as a bucket lane, holding the (b, b)
iterate and an O(b^3) eigh workspace.  For moderate rho the paper's largest
component stays near size p, so that cap on b is the system's scale cap.
This solver is the reference's mesh-spanning one (``sharded.py``):

* the (b, b) iterates are ROW-SHARDED (``core.distributed``: ring matmul,
  one-shard transposes, distributed matvec power iterations).  The port
  runs the one-device case (d = 1), where every shard is the whole padded
  matrix on the card and each operator is its local product;

* the outer loop is the SAME ADMM as the single-device oracle (Boyd 6.5,
  adaptive rho 3.4.1), but the eigh of its Theta-update

      Theta = (M + sqrt(M^2 + 4 rho I)) / (2 rho),   M = rho (Z - U) - S

  is replaced by inner MATRIX ITERATIONS: a warm-vector power iteration
  bounds ||M||_2, and a coupled Newton-Schulz square root (Higham 1997:
  Y <- Y T, Zc <- T Zc with T = (3 I - Zc Y) / 2 on the spectrally scaled
  argument) computes the sqrt with matmuls only.  The inner tolerance is
  tied to the outer primal residual, so early outer iterations are cheap
  and late ones exact;

* the Z/U prox tail (soft-threshold + dual update + both residual
  reductions) is one ``shard_prox`` launch (its plain version on the CPU);

* the returned Z (exactly sparse) is KKT-verified IN PLACE: a warm-started
  column-wise block-CG solves Z W = I (CG also detects a non-PD candidate
  via negative curvature and reports residual = inf), then eq. (11)-(12)
  reduce with one pmax.  The executor compares the residual to
  ``route_check_tol`` and falls back to the single-device iterative tail on
  failure.

Theta-update PD holds by construction, so there is no line search; the only
defensive state is a spectral-scale boost that doubles when a
Newton-Schulz pass fails to contract (non-finite or err growth), reverting
that outer step.

Every ``while_loop`` of the reference is a Python loop here with its state
on the device; the host reads each loop's condition once per step (an NS
or CG step is two or three (bp, bp) products; an outer step is a power
iteration, one product for M^2, the NS steps and the prox).

Counters:  solver.oversize.dispatched / .cg_iters (inner matrix-iteration
steps: Newton-Schulz + verification CG), plus the
``solver.oversize.device_bytes_peak`` watermark — the accounting model is
_BUFFERS_PER_DEVICE row-shards of (b_pad/d, b_pad).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distributed import (
    matvec_rowsharded,
    pmax,
    psum,
    ring_matmul,
    transpose_rowsharded,
)
from repro_torch.core.instrument import bump, set_peak
from repro_torch.kernels.shard_prox.ops import fused_prox_residual

#: exact-sparsity zero classification for the returned Z (same as closed_form)
_ZERO_TOL = 1e-12

#: per-device resident float64 row-shards during a solve: S, the ADMM pair
#: (Z, U), the Theta-update working set (M, M^2 + 4 rho I, Y, Zc, T) and the
#: prox outputs — the memory-model constant behind the bytes watermark
_BUFFERS_PER_DEVICE = 12

#: the port's device count for the sharded solve
N_SHARDS = 1


def sharded_pad_size(b: int, n_shards: int) -> int:
    """Padded size for the sharded solver: the smallest multiple of
    8 * n_shards >= b, so every device owns an equal, 8-row-aligned row
    shard.  Identity padding is exact (Theorem-1 corollary, see blocks.py)."""
    unit = 8 * n_shards
    return max(unit, -(-b // unit) * unit)


@dataclass
class ShardedSolve:
    """One oversize solve: the dense (b, b) Theta plus the verification and
    accounting facts the executor consumes."""

    Theta: np.ndarray
    iters: int                 # outer ADMM iterations
    inner_iters: int           # Newton-Schulz + verification-CG steps
    retries: int               # outer steps reverted by the NS safeguard
    kkt_residual: float        # eq.-(11)/(12) residual of Theta
    s_max: float               # max |S| over the padded block (KKT scale)
    rho: float                 # final (adapted) ADMM penalty
    b: int
    padded: int
    n_shards: int
    device_bytes: int          # accounting-model per-device peak


def pad_rowsharded(S: np.ndarray, *, device="cuda", dtype=None) -> torch.Tensor:
    """Identity-pad a host (b, b) block to the sharded pad size and place it
    on ``device`` (the one shard at d = 1).  Dense-host convenience: the
    streamed oversize path uses ``stream.materialize.shard_gather``."""
    from repro_torch.engine.options import resolve_device  # lazy: import cycle

    b = S.shape[0]
    bp = sharded_pad_size(b, N_SHARDS)
    np_dtype = np.dtype(dtype or S.dtype)
    S_pad = np.eye(bp, dtype=np_dtype)
    S_pad[:b, :b] = S
    return torch.as_tensor(S_pad).to(resolve_device(device))


def _solve(
    S_rows: torch.Tensor, lam: float, rho: float, tol: float, kkt_rel: float, *,
    max_iter: int, ns_max: int, cg_max: int, pow_steps: int,
    theta0_rows: torch.Tensor | None,
):
    """The reference's ``_build_sharded`` body at d = 1; returns (Z, it,
    inner, res, s_max, rho, retries) with the counts as ints."""
    d = N_SHARDS
    bp = S_rows.shape[1]
    rl = bp // d
    dev, dtype = S_rows.device, S_rows.dtype
    gi = torch.arange(rl, device=dev)
    eye_loc = gi[:, None] == torch.arange(bp, device=dev)[None, :]
    eyef = eye_loc.to(dtype)

    def scalar(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=dev)

    inf = scalar(float("inf"))

    def power_norm(A_rows, v):
        """(||A||_2 estimate, refreshed vector) for symmetric A."""
        for _ in range(pow_steps):
            u = matvec_rowsharded(A_rows, v)
            v = u / (torch.linalg.vector_norm(u) + 1e-30)
        u = matvec_rowsharded(A_rows, v)
        return torch.abs(v @ u), u / (torch.linalg.vector_norm(u) + 1e-30)

    def sqrt_ns(A_rows, c, ns_tol):
        """sqrt(A) via the coupled Newton-Schulz iteration on A / c.

        Requires spectrum(A / c) in (0, 3); the caller scales c from the
        power-iteration bound with margin.  Returns (sqrt, steps, ok)."""
        Y, Zc = A_rows / c, eyef
        err, prev_err, k = inf, inf, 0
        while k < ns_max and bool((err > ns_tol) & (err <= prev_err * 4.0)):
            T = 0.5 * (3.0 * eyef - ring_matmul(Zc, Y))
            err_new = pmax(torch.max(torch.abs(T - eyef)))
            Y, Zc, err, prev_err, k = ring_matmul(Y, T), ring_matmul(T, Zc), err_new, err, k + 1
        ok = (err <= ns_tol) & torch.isfinite(Y).all()
        return torch.sqrt(c) * Y, k, ok

    def cg_inverse(A_rows, W_init, cg_tol):
        """Column-wise block-CG on A W = I; returns (W, iters, neg)."""
        R = eyef - ring_matmul(A_rows, W_init)
        rs = psum(torch.sum(R * R, dim=0))
        tol2 = cg_tol * cg_tol
        W, Pc, it = W_init, R, 0
        neg = torch.zeros((), dtype=torch.bool, device=dev)
        while it < cg_max and bool(torch.any(rs > tol2) & ~neg):
            AP = ring_matmul(A_rows, Pc)
            pAp = psum(torch.sum(Pc * AP, dim=0))
            active = rs > tol2
            neg = neg | torch.any(active & (pAp <= 0.0))
            alpha = torch.where(
                active & (pAp > 0.0), rs / torch.where(pAp > 0.0, pAp, 1.0), 0.0
            )
            W = W + Pc * alpha[None, :]
            Rn = R - AP * alpha[None, :]
            rsn = psum(torch.sum(Rn * Rn, dim=0))
            beta = torch.where(active, rsn / torch.where(rs > 0.0, rs, 1.0), 0.0)
            Pc = Rn + Pc * beta[None, :]
            R, rs, it = Rn, rsn, it + 1
        return W, it, neg

    lam_t = scalar(lam)
    rho0 = scalar(rho)
    diag_own = torch.sum(torch.where(eye_loc, S_rows, 0.0), dim=1)
    cold = torch.where(eye_loc, (1.0 / (diag_own + lam_t))[:, None], 0.0)
    if theta0_rows is not None:
        # At the ADMM fixed point U* = (Theta*^{-1} - S) / rho: seeding BOTH
        # Z and U from Theta0 makes an exact warm start a fixed point; one
        # CG inverse buys that dual (the dense ``admm`` W0 argument).
        diag_t0 = torch.sum(torch.where(eye_loc, theta0_rows, 0.0), dim=1)
        Wt0 = torch.where(eye_loc, (1.0 / diag_t0)[:, None], 0.0)
        Wt, _, neg0 = cg_inverse(theta0_rows, Wt0, 1e-8)
        usable = ~neg0 & torch.isfinite(Wt).all()
        Z = torch.where(usable, theta0_rows, cold)
        U = torch.where(usable, (Wt - S_rows) / rho0, torch.zeros_like(S_rows))
    else:
        Z, U = cold, torch.zeros_like(S_rows)
    v = torch.ones(bp, dtype=dtype, device=dev) / torch.sqrt(scalar(float(bp)))

    def kkt_of(Zf, W_warm, inner_tol):
        """eq.-(11)/(12) residual of a symmetrized iterate."""
        Wz, cg_k, neg = cg_inverse(Zf, W_warm, inner_tol)
        Wz = 0.5 * (Wz + transpose_rowsharded(Wz))
        zero = torch.abs(Zf) <= _ZERO_TOL
        off = ~eye_loc
        v_zero = torch.max(torch.where(
            zero & off, torch.clamp(torch.abs(S_rows - Wz) - lam_t, min=0.0), 0.0))
        v_act = torch.max(torch.where(
            ~zero & off, torch.abs(Wz - S_rows - lam_t * torch.sign(Zf)), 0.0))
        v_diag = torch.max(torch.where(eye_loc, torch.abs(Wz - S_rows - lam_t), 0.0))
        res = pmax(torch.maximum(torch.maximum(v_zero, v_act), v_diag))
        return torch.where(neg, inf, res), Wz, cg_k

    s_max = pmax(torch.max(torch.abs(S_rows)))
    kkt_target = kkt_rel * torch.clamp(s_max, min=1.0)
    two, half, one = scalar(2.0), scalar(0.5), scalar(1.0)

    rho_t, boost = rho0, scalar(1.5)
    rp, rd = inf, inf
    it = inner = 0
    retries = torch.zeros((), dtype=torch.int32, device=dev)
    eps = tol * bp
    W_warm = cold
    res = inf
    att = 0
    # ADMM-until-verified: each attempt runs the ADMM loop to its eps, then
    # VERIFIES the KKT residual in place; a miss tightens eps 20x and
    # continues warm (same Z/U/rho, no restart).  att == 0 forces the first
    # attempt even with no KKT target (kkt_target = inf).
    while (
        it < max_iter and att < 4
        and bool((retries < 30) & ((res > kkt_target) | (att == 0)))
    ):
        while it < max_iter and bool((retries < 30) & ((rp > eps) | (rd > eps))):
            M = rho_t * (Z - U) - S_rows
            m, vn = power_norm(M, v)
            cscale = boost * (m * m + 4.0 * rho_t)
            ns_tol = torch.clamp(1e-3 * rp / bp, 1e-11, 1e-2)
            A = ring_matmul(M, M) + 4.0 * rho_t * eyef
            R_sqrt, ns_k, ns_ok = sqrt_ns(A, cscale, ns_tol)
            Theta = (M + R_sqrt) / (2.0 * rho_t)
            Zn, Un, rp2_l, rd2_l = fused_prox_residual(Theta, U, Z, lam_t / rho_t)
            rp_n = torch.sqrt(psum(rp2_l))
            rd_n = rho_t * torch.sqrt(psum(rd2_l))
            factor = torch.where(
                rp_n > 10.0 * rd_n, two, torch.where(rd_n > 10.0 * rp_n, half, one)
            )
            ok = ns_ok & torch.isfinite(rp_n) & torch.isfinite(rd_n)
            Z = torch.where(ok, Zn, Z)
            U = torch.where(ok, Un / factor, U)
            v = vn
            rho_t = torch.where(ok, rho_t * factor, rho_t)
            boost = torch.where(ok, boost, 2.0 * boost)
            rp = torch.where(ok, rp_n, rp)
            rd = torch.where(ok, rd_n, rd)
            it += 1
            inner += ns_k
            retries = retries + (~ok).to(retries.dtype)
        Z = 0.5 * (Z + transpose_rowsharded(Z))
        res, W_warm, cg_k = kkt_of(Z, W_warm, min(1e-8, tol))
        inner += cg_k
        eps = 0.05 * eps
        att += 1
    return Z, it, inner, float(res), float(s_max), float(rho_t), int(retries)


def glasso_sharded(
    S,
    lam: float,
    *,
    b: int | None = None,
    rho: float = 1.0,
    max_iter: int = 6000,
    tol: float = 1e-9,
    kkt_target: float | None = None,
    ns_max: int = 60,
    cg_max: int | None = None,
    pow_steps: int = 10,
    dtype=None,
    Theta0: np.ndarray | torch.Tensor | None = None,
    device="cuda",
) -> ShardedSolve:
    """Solve one oversize block; see the module docstring.

    ``S`` is either a host (b, b) array (padded and placed on ``device``
    here: the card unless ``device="cpu"``) or an already padded (bp, bp)
    tensor, which stays on its own device (then ``b`` gives the true block
    size — the shard-direct gather's calling convention).  ``Theta0``
    warm-starts Z and U (a previous (b, b) solution on the same support,
    host array or tensor).
    ``kkt_target`` is the caller's RELATIVE acceptance tolerance (the
    executor's ``route_check_tol``): after the ADMM loop reaches ``tol``,
    the in-place KKT residual is checked against
    ``kkt_target * max(1, max|S|)`` and a miss tightens the stopping eps
    20x and continues warm (up to 4 attempts within ``max_iter``).  Returns
    a ``ShardedSolve``; ``Theta`` is the host (b, b) solution and
    ``kkt_residual`` the in-place eq.-(11)/(12) verification."""
    d = N_SHARDS
    if isinstance(S, torch.Tensor):
        bp = S.shape[0]
        if b is None:
            raise ValueError("pre-sharded S needs the true block size (b=...)")
        if bp != sharded_pad_size(b, d):
            raise ValueError(
                f"pre-sharded S is {bp}x{bp}; expected padded size "
                f"{sharded_pad_size(b, d)} for b={b} on {d} shards"
            )
        S_sh = S if dtype is None else S.to(getattr(torch, np.dtype(dtype).name))
    else:
        S = np.asarray(S)
        b = S.shape[0]
        S_sh = pad_rowsharded(S, device=device, dtype=dtype or np.float64)
        bp = S_sh.shape[0]
    if cg_max is None:
        cg_max = bp
    theta0 = None
    if Theta0 is not None:
        # a device tensor (a path's kept solution) stays on the device
        theta0 = torch.eye(bp, dtype=S_sh.dtype, device=S_sh.device) / (1.0 + float(lam))
        theta0[:b, :b] = torch.as_tensor(Theta0, device=S_sh.device)
    Z, it, inner, res, s_max, rho_f, retries = _solve(
        S_sh, float(lam), float(rho), float(tol),
        float("inf") if kkt_target is None else float(kkt_target),
        max_iter=int(max_iter), ns_max=int(ns_max), cg_max=int(cg_max),
        pow_steps=int(pow_steps), theta0_rows=theta0,
    )
    device_bytes = _BUFFERS_PER_DEVICE * (bp // d) * bp * S_sh.element_size()
    bump("solver.oversize.dispatched")
    bump("solver.oversize.cg_iters", int(inner))
    set_peak("solver.oversize.device_bytes_peak", device_bytes)
    return ShardedSolve(
        Theta=Z[:b, :b].cpu().numpy(),
        iters=int(it),
        inner_iters=int(inner),
        retries=int(retries),
        kkt_residual=res,
        s_max=s_max,
        rho=rho_f,
        b=int(b),
        padded=int(bp),
        n_shards=int(d),
        device_bytes=int(device_bytes),
    )
