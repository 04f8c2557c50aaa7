"""Plain PyTorch version of the fused prox step of the joint multi-class
ADMM, batched over lanes.

One joint-ADMM iteration ends with the Z-update: at every matrix entry
(i, j) the K class values are proximal-mapped JOINTLY under the composite
penalty lam1 * l1 + lam2 * P2, where P2 couples the classes:

    group  P2 = sqrt(sum_k theta_k^2)            (off-diagonal entries)
    fused  P2 = sum_{k<k'} |theta_k - theta_k'|  (off-diagonal entries)

Both composite proxes have exact closed forms:

    group  prox_{t1 l1 + t2 l2}   = group-shrink  o  soft(., t1)
    fused  prox_{t1 l1 + t2 TV_K} = soft(., t1)  o  prox_{t2 TV_K}

with TV_K the complete-graph total variation over the K classes.  Its prox
is computed without a sort, in the reference's own sequence (which the
CUDA kernel repeats operation for operation): stable ranks from K^2
pairwise comparisons, the rank-r order statistics via one-hot sums, the
stationarity shift b_r = a_(r) - t(2r - K + 1), prefix sums, segment means
num / length and the minimax isotonic fit
y_r = max_{j<=r} min_{l>=r} mean(b_j..b_l), gathered back by rank.  Tied
inputs give tied outputs.

Diagonal entries take only the l1 piece (lam2 is off-diagonal).  The
residual partials rp2 = sum((Theta - Z_new)^2) and
rd2 = sum((Z_new - Z_old)^2) sum over all K classes of a lane.

Lanes: ``joint_prox_ref`` takes (n, K, b, b) stacks and ``t`` of shape
(n, 2) holding [lam1/rho, lam2/rho] per lane — what the reference computes
when ``jax.vmap`` maps its per-block step over a bucket.  The
single-block functions below work along axis 0 of a (K, ...) tensor, with
``t`` a scalar or broadcastable to the trailing shape.
"""

from __future__ import annotations

import torch

PENALTIES = ("group", "fused")


def _soft(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def group_prox(a: torch.Tensor, t1, t2) -> torch.Tensor:
    """prox of t1*||.||_1 + t2*||.||_2 along axis 0 of a (K, ...) tensor."""
    v = _soft(a, t1)
    nrm = torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))
    pos = nrm > 0.0
    safe = torch.where(pos, nrm, torch.ones_like(nrm))
    scale = torch.where(
        pos, torch.clamp(1.0 - t2 / safe, min=0.0), torch.zeros_like(nrm)
    )
    return v * scale


def tv_complete_prox(a: torch.Tensor, t) -> torch.Tensor:
    """prox of t * sum_{k<k'} |x_k - x_k'| along axis 0 of a (K, ...)
    tensor, sort-free (module docstring); every loop is over K."""
    K = a.shape[0]
    if K == 1:
        return a
    tail = (1,) * (a.ndim - 1)
    pos = torch.arange(K, device=a.device).reshape((K,) + tail)
    # stable rank: #(strictly smaller) + #(equal with smaller class index)
    ai, aj = a[:, None], a[None, :]
    pi, pj = pos[:, None], pos[None, :]
    less = (aj < ai) | ((aj == ai) & (pj < pi))
    rank = torch.sum(less.to(a.dtype), dim=1)  # (K, ...), values 0..K-1
    # order statistics a_(r) via one-hot contraction
    r_ids = torch.arange(K, dtype=a.dtype, device=a.device).reshape((K,) + (1,) * a.ndim)
    onehot = (rank[None] == r_ids).to(a.dtype)  # (Kr, K, ...)
    asort = torch.sum(onehot * a[None], dim=1)  # (K, ...) ascending
    # stationarity shift for strictly ordered coordinates
    c = (2.0 * torch.arange(K, dtype=a.dtype, device=a.device) - (K - 1)).reshape((K,) + tail)
    b = asort - t * c
    # prefix sums P[r] = sum of the first r shifted values
    parts = [torch.zeros_like(a[0])]
    for r in range(K):
        parts.append(parts[-1] + b[r])
    prefix = torch.stack(parts)  # (K+1, ...)
    # segment means M[j, l] = mean(b_j..b_l); only j <= l is read below
    num = prefix[None, 1:] - prefix[:-1, None]  # (j, l, ...)
    ar = torch.arange(K, dtype=a.dtype, device=a.device)
    length = torch.clamp(ar[None, :] - ar[:, None] + 1.0, min=1.0)
    M = num / length.reshape((K, K) + tail)
    # isotonic fit via minimax: y_r = max_{j<=r} min_{l>=r} M[j, l]
    ys = []
    for r in range(K):
        inner = torch.amin(M[:, r:], dim=1)  # min over l >= r, for every j
        ys.append(torch.amax(inner[: r + 1], dim=0))
    ysort = torch.stack(ys)  # (K, ...) nondecreasing
    # gather back by rank
    return torch.sum(onehot * ysort[:, None], dim=0)


def fused_prox(a: torch.Tensor, t1, t2) -> torch.Tensor:
    """prox of t1*||.||_1 + t2*TV_complete along axis 0 of a (K, ...) tensor."""
    return _soft(tv_complete_prox(a, t2), t1)


def joint_prox_entries(a: torch.Tensor, t1, t2, *, penalty: str) -> torch.Tensor:
    """Off-diagonal joint prox along the class axis (axis 0)."""
    if penalty == "group":
        return group_prox(a, t1, t2)
    if penalty == "fused":
        return fused_prox(a, t1, t2)
    raise ValueError(f"unknown joint penalty {penalty!r}; available: {PENALTIES}")


def joint_prox_ref(
    theta: torch.Tensor,
    u: torch.Tensor,
    z_old: torch.Tensor,
    t: torch.Tensor,
    *,
    penalty: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Z_new, U_new, rp2, rd2) for a bucket of lanes.

    theta/u/z_old: (n, K, b, b); t: (n, 2) = [lam1/rho, lam2/rho] per lane.
    Z_new and U_new are (n, K, b, b); rp2 and rd2 are (n,)."""
    n, K, b, _ = theta.shape
    t = t.to(theta.dtype)
    t1 = t[:, 0].reshape(n, 1, 1)
    t2 = t[:, 1].reshape(n, 1, 1)
    a = theta + u
    z_off = joint_prox_entries(a.transpose(0, 1), t1, t2, penalty=penalty).transpose(0, 1)
    eye = torch.eye(b, dtype=torch.bool, device=theta.device)
    z_new = torch.where(eye, _soft(a, t1[:, None]), z_off)
    u_new = a - z_new
    rp2 = torch.sum((theta - z_new) ** 2, dim=(1, 2, 3))
    rd2 = torch.sum((z_new - z_old) ** 2, dim=(1, 2, 3))
    return z_new, u_new, rp2, rd2
