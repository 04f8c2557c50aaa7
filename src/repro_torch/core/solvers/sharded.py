"""Matmul-only ADMM for OVERSIZE blocks, on the row-sharded layout.

Every other solver runs one block as a bucket lane, holding the (b, b)
iterate and an O(b^3) eigh workspace.  For moderate rho the paper's largest
component stays near size p, so that cap on b is the system's scale cap.
This solver is the reference's mesh-spanning one (``sharded.py``):

* the (b, b) iterates are ROW-SHARDED across a mesh of d devices for the
  whole solve (``core.distributed``: ring matmuls, one-shard all-to-all
  transposes, distributed matvec power iterations, psum/pmax
  reductions); no stage ever forms the full (b, b) matrix on one device.
  The mesh is a tuple of devices and may repeat one (d logical shards on
  one card); at d = 1 every operator is its local product, so the
  one-device solve keeps its bits;

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
  reductions) is one ``shard_prox`` launch a shard (its plain version on a
  CPU shard), the residuals psum-reduced;

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
on the devices (a replicated scalar or vector on the mesh's first device);
the host reads each loop's condition once per step (an NS or CG step is
two or three ring matmuls; an outer step is a power iteration, one ring
matmul for M^2, the NS steps and the prox).  Iteration counts at d > 1 may
differ from d = 1's by a few: the reductions add in another order.

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
    as_mesh,
    eye_rows,
    local_device_mesh,
    matvec_rowsharded,
    pall,
    pmax,
    psum,
    replica,
    ring_matmul,
    split_rows,
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


def pad_rowsharded(S: np.ndarray, mesh=None, *, dtype=None, device="cuda") -> list:
    """Identity-pad a host (b, b) block to the sharded pad size and place
    it row-sharded on ``mesh`` (``local_device_mesh(device)`` by default):
    a list of d (bp/d, bp) tensors.  Dense-host convenience: the streamed
    oversize path uses ``stream.materialize.shard_gather``."""
    mesh = local_device_mesh(device) if mesh is None else as_mesh(mesh)
    b = S.shape[0]
    bp = sharded_pad_size(b, len(mesh))
    np_dtype = np.dtype(dtype or S.dtype)
    S_pad = np.eye(bp, dtype=np_dtype)
    S_pad[:b, :b] = S
    return split_rows(S_pad, mesh)


def _solve(
    S_rows: list, lam: float, rho: float, tol: float, kkt_rel: float, *,
    max_iter: int, ns_max: int, cg_max: int, pow_steps: int,
    theta0_rows: list | None,
):
    """The reference's ``_build_sharded`` body over the d row shards of
    ``S_rows``; returns (Z shards, it, inner, res, s_max, rho, retries)
    with the counts as ints.  Per-shard work runs on each shard's device;
    the replicated scalars and vectors live on the first shard's device
    and are copied to a shard where it uses them (``rep``)."""
    rl, bp = S_rows[0].shape
    devs = [s.device for s in S_rows]
    home, dtype = devs[0], S_rows[0].dtype
    eye_loc = [
        eye_rows(k * rl, rl, bp, dtype=torch.bool, device=dev) for k, dev in enumerate(devs)
    ]
    eyef = [e.to(dtype) for e in eye_loc]

    def scalar(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=home)

    def rep(x: torch.Tensor, k: int) -> torch.Tensor:
        """A replicated value on shard k's device."""
        return replica(x, devs[k])

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
        Y = [a / rep(c, k) for k, a in enumerate(A_rows)]
        Zc = eyef
        err, prev_err, k = inf, inf, 0
        while k < ns_max and bool((err > ns_tol) & (err <= prev_err * 4.0)):
            T = [0.5 * (3.0 * e - zy) for e, zy in zip(eyef, ring_matmul(Zc, Y))]
            err_new = pmax([torch.max(torch.abs(t - e)) for t, e in zip(T, eyef)])
            Y, Zc, err, prev_err, k = ring_matmul(Y, T), ring_matmul(T, Zc), err_new, err, k + 1
        ok = (err <= ns_tol) & pall([torch.isfinite(y).all() for y in Y])
        root = torch.sqrt(c)
        return [rep(root, j) * y for j, y in enumerate(Y)], k, ok

    def cg_inverse(A_rows, W_init, cg_tol):
        """Column-wise block-CG on A W = I; returns (W, iters, neg)."""
        R = [e - aw for e, aw in zip(eyef, ring_matmul(A_rows, W_init))]
        rs = psum([torch.sum(r * r, dim=0) for r in R])
        tol2 = cg_tol * cg_tol
        W, Pc, it = W_init, R, 0
        neg = torch.zeros((), dtype=torch.bool, device=home)
        while it < cg_max and bool(torch.any(rs > tol2) & ~neg):
            AP = ring_matmul(A_rows, Pc)
            pAp = psum([torch.sum(pc * ap, dim=0) for pc, ap in zip(Pc, AP)])
            active = rs > tol2
            neg = neg | torch.any(active & (pAp <= 0.0))
            alpha = torch.where(
                active & (pAp > 0.0), rs / torch.where(pAp > 0.0, pAp, 1.0), 0.0
            )
            W = [w + pc * rep(alpha, k)[None, :] for k, (w, pc) in enumerate(zip(W, Pc))]
            Rn = [r - ap * rep(alpha, k)[None, :] for k, (r, ap) in enumerate(zip(R, AP))]
            rsn = psum([torch.sum(rn * rn, dim=0) for rn in Rn])
            beta = torch.where(active, rsn / torch.where(rs > 0.0, rs, 1.0), 0.0)
            Pc = [rn + pc * rep(beta, k)[None, :] for k, (rn, pc) in enumerate(zip(Rn, Pc))]
            R, rs, it = Rn, rsn, it + 1
        return W, it, neg

    lam_t = scalar(lam)
    rho0 = scalar(rho)
    diag_own = [torch.sum(torch.where(e, s, 0.0), dim=1) for e, s in zip(eye_loc, S_rows)]
    cold = [
        torch.where(e, (1.0 / (dg + rep(lam_t, k)))[:, None], 0.0)
        for k, (e, dg) in enumerate(zip(eye_loc, diag_own))
    ]
    if theta0_rows is not None:
        # At the ADMM fixed point U* = (Theta*^{-1} - S) / rho: seeding BOTH
        # Z and U from Theta0 makes an exact warm start a fixed point; one
        # CG inverse buys that dual (the dense ``admm`` W0 argument).
        Wt0 = [
            torch.where(e, (1.0 / torch.sum(torch.where(e, t0, 0.0), dim=1))[:, None], 0.0)
            for e, t0 in zip(eye_loc, theta0_rows)
        ]
        Wt, _, neg0 = cg_inverse(theta0_rows, Wt0, 1e-8)
        usable = ~neg0 & pall([torch.isfinite(w).all() for w in Wt])
        Z = [torch.where(rep(usable, k), t0, c)
             for k, (t0, c) in enumerate(zip(theta0_rows, cold))]
        U = [torch.where(rep(usable, k), (w - s) / rep(rho0, k), torch.zeros_like(s))
             for k, (w, s) in enumerate(zip(Wt, S_rows))]
    else:
        Z, U = cold, [torch.zeros_like(s) for s in S_rows]
    v = torch.ones(bp, dtype=dtype, device=home) / torch.sqrt(scalar(float(bp)))

    def kkt_of(Zf, W_warm, inner_tol):
        """eq.-(11)/(12) residual of a symmetrized iterate."""
        Wz, cg_k, neg = cg_inverse(Zf, W_warm, inner_tol)
        Wz = [0.5 * (w + wt) for w, wt in zip(Wz, transpose_rowsharded(Wz))]
        local = []
        for k, (z, w, s, e) in enumerate(zip(Zf, Wz, S_rows, eye_loc)):
            lam_k = rep(lam_t, k)
            zero = torch.abs(z) <= _ZERO_TOL
            off = ~e
            v_zero = torch.max(torch.where(
                zero & off, torch.clamp(torch.abs(s - w) - lam_k, min=0.0), 0.0))
            v_act = torch.max(torch.where(
                ~zero & off, torch.abs(w - s - lam_k * torch.sign(z)), 0.0))
            v_diag = torch.max(torch.where(e, torch.abs(w - s - lam_k), 0.0))
            local.append(torch.maximum(torch.maximum(v_zero, v_act), v_diag))
        return torch.where(neg, inf, pmax(local)), Wz, cg_k

    s_max = pmax([torch.max(torch.abs(s)) for s in S_rows])
    kkt_target = kkt_rel * torch.clamp(s_max, min=1.0)
    two, half, one = scalar(2.0), scalar(0.5), scalar(1.0)

    rho_t, boost = rho0, scalar(1.5)
    rp, rd = inf, inf
    it = inner = 0
    retries = torch.zeros((), dtype=torch.int32, device=home)
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
            M = [rep(rho_t, k) * (z - u) - s for k, (z, u, s) in enumerate(zip(Z, U, S_rows))]
            m, vn = power_norm(M, v)
            cscale = boost * (m * m + 4.0 * rho_t)
            ns_tol = torch.clamp(1e-3 * rp / bp, 1e-11, 1e-2)
            A = [mm + 4.0 * rep(rho_t, k) * e
                 for k, (mm, e) in enumerate(zip(ring_matmul(M, M), eyef))]
            R_sqrt, ns_k, ns_ok = sqrt_ns(A, cscale, ns_tol)
            t = lam_t / rho_t
            prox = [
                fused_prox_residual((mk + r) / (2.0 * rep(rho_t, k)), u, z, rep(t, k))
                for k, (mk, r, u, z) in enumerate(zip(M, R_sqrt, U, Z))
            ]
            rp_n = torch.sqrt(psum([x[2] for x in prox]))
            rd_n = rho_t * torch.sqrt(psum([x[3] for x in prox]))
            factor = torch.where(
                rp_n > 10.0 * rd_n, two, torch.where(rd_n > 10.0 * rp_n, half, one)
            )
            ok = ns_ok & torch.isfinite(rp_n) & torch.isfinite(rd_n)
            Z = [torch.where(rep(ok, k), x[0], z) for k, (x, z) in enumerate(zip(prox, Z))]
            U = [torch.where(rep(ok, k), x[1] / rep(factor, k), u)
                 for k, (x, u) in enumerate(zip(prox, U))]
            v = vn
            rho_t = torch.where(ok, rho_t * factor, rho_t)
            boost = torch.where(ok, boost, 2.0 * boost)
            rp = torch.where(ok, rp_n, rp)
            rd = torch.where(ok, rd_n, rd)
            it += 1
            inner += ns_k
            retries = retries + (~ok).to(retries.dtype)
        Z = [0.5 * (z + zt) for z, zt in zip(Z, transpose_rowsharded(Z))]
        res, W_warm, cg_k = kkt_of(Z, W_warm, min(1e-8, tol))
        inner += cg_k
        eps = 0.05 * eps
        att += 1
    return Z, it, inner, float(res), float(s_max), float(rho_t), int(retries)


def glasso_sharded(
    S,
    lam: float,
    *,
    mesh=None,
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
    """Solve one oversize block across ``mesh``; see the module docstring.

    ``S`` is a host (b, b) array, identity-padded and placed row-sharded on
    the mesh here (``mesh=None``: ``local_device_mesh(device)``, the card,
    or every card, unless ``device="cpu"``); or an already padded
    row-sharded block (then ``b`` gives the true block size — the
    shard-direct gather's calling convention): the list of its d row
    shards, which stay on their own devices, or one (bp, bp) tensor, a
    single shard.  A pre-sharded S whose shard count differs from
    ``mesh``'s, or whose padded size is not ``sharded_pad_size(b, d)``,
    raises.  ``Theta0`` warm-starts Z and U (a previous (b, b) solution on
    the same support, host array or tensor).
    ``kkt_target`` is the caller's RELATIVE acceptance tolerance (the
    executor's ``route_check_tol``): after the ADMM loop reaches ``tol``,
    the in-place KKT residual is checked against
    ``kkt_target * max(1, max|S|)`` and a miss tightens the stopping eps
    20x and continues warm (up to 4 attempts within ``max_iter``).  Returns
    a ``ShardedSolve``; ``Theta`` is the host (b, b) solution and
    ``kkt_residual`` the in-place eq.-(11)/(12) verification."""
    t_dtype = None if dtype is None else getattr(torch, np.dtype(dtype).name)
    if isinstance(S, (torch.Tensor, list, tuple)):
        shards = [S] if isinstance(S, torch.Tensor) else list(S)
        d = len(shards)
        if mesh is not None and len(as_mesh(mesh)) != d:
            raise ValueError(
                f"pre-sharded S has {d} row shards; the mesh has {len(as_mesh(mesh))}"
            )
        bp = shards[0].shape[1]
        if b is None:
            raise ValueError("pre-sharded S needs the true block size (b=...)")
        if bp != sharded_pad_size(b, d) or any(s.shape != (bp // d, bp) for s in shards):
            raise ValueError(
                f"pre-sharded S is {d} shards of {tuple(shards[0].shape)}; expected padded "
                f"size {sharded_pad_size(b, d)} for b={b} on {d} shards"
            )
        S_rows = shards if t_dtype is None else [s.to(t_dtype) for s in shards]
    else:
        S = np.asarray(S)
        b = S.shape[0]
        S_rows = pad_rowsharded(S, mesh, dtype=dtype or np.float64, device=device)
        d = len(S_rows)
        bp = S_rows[0].shape[1]
    if cg_max is None:
        cg_max = bp
    rl = bp // d
    theta0 = None
    if Theta0 is not None:
        # a device tensor (a path's kept solution) stays on the devices
        theta0 = []
        for k, s in enumerate(S_rows):
            lo, hi = k * rl, (k + 1) * rl
            t0 = eye_rows(lo, rl, bp, dtype=s.dtype, device=s.device) / (1.0 + float(lam))
            if lo < b:
                t0[: min(hi, b) - lo, :b] = torch.as_tensor(Theta0[lo:min(hi, b)], device=s.device)
            theta0.append(t0)
    Z, it, inner, res, s_max, rho_f, retries = _solve(
        S_rows, float(lam), float(rho), float(tol),
        float("inf") if kkt_target is None else float(kkt_target),
        max_iter=int(max_iter), ns_max=int(ns_max), cg_max=int(cg_max),
        pow_steps=int(pow_steps), theta0_rows=theta0,
    )
    device_bytes = _BUFFERS_PER_DEVICE * rl * bp * S_rows[0].element_size()
    bump("solver.oversize.dispatched")
    bump("solver.oversize.cg_iters", int(inner))
    set_peak("solver.oversize.device_bytes_peak", device_bytes)
    Theta = np.concatenate([z[:, :b].cpu().numpy() for z in Z[: -(-b // rl)]])[:b]
    return ShardedSolve(
        Theta=Theta,
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
