"""Joint-KKT verification for the K-class graphical lasso.

The single-class router verifies fast-path candidates against the canonical
``kkt_residual`` (paper eq. (11)-(12)).  The joint stationarity condition
per off-diagonal entry (i, j) couples the classes through the cross-penalty
subgradient:

    W_k,ij - S_k,ij = lam1 z_k + lam2 c_k,   z_k in d|theta_k|,
                                             c  in dP2(theta_ij,:)

so "residual" means: how far is r = (W_k,ij - S_k,ij)_k from the SET of
admissible right-hand sides.  That distance has closed form for both
penalties:

  group   theta != 0: c = theta/||theta|| is a singleton — per-class check
          with the forced c_k (zero coordinates get the usual lam1 slack);
          theta == 0: shrink each r_k by lam1, then the leftover vector must
          fit in the lam2 ball: max(||soft(|r|, lam1)||_2 - lam2, 0).

  fused   cross-class y_kk' are forced to sign(theta_k - theta_k') wherever
          the values differ and free in [-1, 1] on TIES, so after removing
          the forced contributions the feasibility WITHIN each tied group is
          exactly the subset-sum system of the hybrid screen
          (``screen.fused_subset_excess``) — with per-coordinate slack lam1
          on all-zero groups (z free) and slack 0 on active groups (z
          forced to the common sign).

With lam2 = 0 both reduce to the canonical per-class condition, and the
verifier literally delegates to ``kkt_residual_host`` per class — the
joint verifier cannot drift from the single-class optimality definition.

This is the safety net behind the joint routing ladder: closed-form
"joint_forest" candidates are accepted only on sufficiency (see
``repro_torch.joint.engine``), and joint-ADMM outputs whose residual exceeds the
tolerance are re-dispatched (``joint.fallbacks``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.joint.screen import _check_penalty, fused_subset_excess

#: joint-ADMM candidates are exactly sparse off-support (the prox output),
#: so the zero classification can be tight — same rationale as closed_form
_ZERO_TOL = 1e-9
_TIE_TOL = 1e-8


def _fused_entry_violation(
    theta: np.ndarray, r: np.ndarray, lam1: float, lam2: float,
    zero_tol: float, tie_tol: float,
) -> float:
    """Worst fused-stationarity violation for one entry's K-vectors."""
    K = theta.size
    order = np.argsort(theta, kind="stable")
    ts, rs = theta[order], r[order]
    scale = max(1.0, float(np.abs(ts).max()))
    # tie groups: consecutive sorted values within tie_tol * scale
    bounds = [0]
    for k in range(1, K):
        if ts[k] - ts[bounds[-1]] > tie_tol * scale:
            bounds.append(k)
    bounds.append(K)
    groups = [slice(bounds[g], bounds[g + 1]) for g in range(len(bounds) - 1)]
    worst = 0.0
    for g, sl in enumerate(groups):
        m = sl.stop - sl.start
        n_lower = sl.start
        n_higher = K - sl.stop
        d = rs[sl] - lam2 * (n_lower - n_higher)
        if np.all(np.abs(ts[sl]) <= zero_tol):
            slack = lam1
        else:
            d = d - lam1 * np.sign(ts[sl])
            slack = 0.0
        worst = max(worst, float(fused_subset_excess(d, slack, lam2)))
    return worst


def joint_kkt_residual(
    Ss,
    Thetas,
    lam1: float,
    lam2: float,
    *,
    penalty: str = "group",
    zero_tol: float = _ZERO_TOL,
    tie_tol: float = _TIE_TOL,
) -> float:
    """Worst joint-KKT violation of a candidate (K, b, b) Theta stack.

    Host numpy (the verifier runs per block after the solve, like the
    chordal route's host check).  NaN/indefinite candidates return inf so
    callers' ``residual <= tol`` comparisons fail safely."""
    _check_penalty(penalty)
    S = np.stack([np.asarray(s, dtype=np.float64) for s in Ss])
    T = np.stack([np.asarray(t, dtype=np.float64) for t in Thetas])
    K, b, _ = S.shape
    if not np.isfinite(T).all():
        return float("inf")
    if lam2 == 0.0:
        # exact reduction: the canonical per-class residual IS the joint one
        from repro_torch.core.solvers.closed_form import kkt_residual_host

        return max(kkt_residual_host(S[k], lam1, T[k]) for k in range(K))
    W = np.empty_like(T)
    for k in range(K):
        sign, _ = np.linalg.slogdet(T[k])
        if sign <= 0:
            return float("inf")
        W[k] = np.linalg.inv(T[k])
    r = W - S
    # diagonal: per-class W_ii = S_ii + lam1 (lam2 is off-diagonal only)
    diag = np.abs(np.diagonal(r, axis1=1, axis2=2) - lam1)
    worst = float(diag.max())
    iu, ju = np.triu_indices(b, 1)
    if penalty == "group":
        tvec = T[:, iu, ju]                      # (K, E)
        rvec = r[:, iu, ju]
        nrm = np.sqrt(np.sum(tvec * tvec, axis=0))
        active_vec = nrm > zero_tol
        # theta == 0 entirely: leftover after lam1 shrink must fit lam2 ball
        soft = np.maximum(np.abs(rvec) - lam1, 0.0)
        v_zero = np.maximum(
            np.sqrt(np.sum(soft * soft, axis=0)) - lam2, 0.0
        )
        # theta != 0: c_k = theta_k/||theta|| is forced (zero coords incl.)
        safe = np.where(active_vec, nrm, 1.0)
        forced = lam2 * tvec / safe
        act_coord = np.abs(tvec) > zero_tol
        v_act = np.where(
            act_coord,
            np.abs(rvec - lam1 * np.sign(tvec) - forced),
            np.maximum(np.abs(rvec - forced) - lam1, 0.0),
        ).max(axis=0)
        per_pair = np.where(active_vec, v_act, v_zero)
        return max(worst, float(per_pair.max()) if per_pair.size else 0.0)
    for i, j in zip(iu, ju):
        worst = max(
            worst,
            _fused_entry_violation(
                T[:, i, j], r[:, i, j], lam1, lam2, zero_tol, tie_tol
            ),
        )
    return worst


def joint_kkt_residual_sparse(
    Ss,
    Theta,
    lam1: float,
    lam2: float,
    *,
    penalty: str = "group",
    zero_tol: float = _ZERO_TOL,
    tie_tol: float = _TIE_TOL,
) -> float:
    """Worst joint-KKT violation of a block-sparse K-class result.

    ``Theta`` is a ``repro_torch.core.sparse.JointSparseTheta``; per union
    component the per-class S blocks are gathered and the dense per-block
    verifier runs unchanged — never a (K, p, p) buffer.  Cross-component
    entries are certified by the hybrid screen (both the (G) and (F)
    conditions hold at theta = 0 there), as in the single-class Theorem-1
    argument; isolated vertices check their per-class closed form
    W_ii = S_ii + lam1 exactly (lam2 never touches the diagonal)."""
    from repro_torch.core.blocks import gather_diag, gather_submatrix
    from repro_torch.core.instrument import set_peak

    _check_penalty(penalty)
    worst = 0.0
    for c, blk in Theta.blocks():
        Sb = np.stack(
            [gather_submatrix(S, c, dtype=np.float64) for S in Ss]
        )
        # working set: per-class S, Theta, and W = inv(Theta) blocks
        set_peak("result.bytes_peak", int(3 * Sb.nbytes))
        worst = max(
            worst,
            joint_kkt_residual(
                Sb, np.asarray(blk), lam1, lam2, penalty=penalty,
                zero_tol=zero_tol, tie_tol=tie_tol,
            ),
        )
    iso = Theta.isolated
    if iso.size:
        for k, S in enumerate(Ss):
            d = np.asarray(gather_diag(S, iso), dtype=np.float64)
            vals = np.asarray(Theta.isolated_values[k], dtype=np.float64)
            worst = max(
                worst, float(np.abs(1.0 / vals - d - float(lam1)).max())
            )
    return float(worst)


def joint_kkt_ok(
    Ss, Thetas, lam1: float, lam2: float, *, penalty: str, tol: float
) -> bool:
    """Acceptance check with the router's usual max|S| scaling."""
    scale = max(1.0, max(float(np.abs(np.asarray(S)).max()) for S in Ss))
    res = joint_kkt_residual(Ss, Thetas, lam1, lam2, penalty=penalty)
    return bool(res <= tol * scale)
