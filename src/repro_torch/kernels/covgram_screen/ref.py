"""Plain PyTorch version of the covgram_screen kernel.

The same contract as the reference's numpy oracle ``covgram_screen_ref``:
centered product, divide by n after the sum, strict threshold, all in the
INPUT dtype — under float64 inputs the emitted tile values agree exactly
with a dense ``(X - mu)'(X - mu) / n`` estimator on exactly representable
data, which the streamed-vs-dense tie tests rely on."""

from __future__ import annotations

import torch


def covgram_screen_ref(
    x: torch.Tensor,
    mu: torch.Tensor,
    i_idx: torch.Tensor,
    j_idx: torch.Tensor,
    lam: float,
    *,
    n_true: int,
    p_true: int,
    block_p: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vals (B, bp, bp), counts (B,) int32, stats (B, 2)) for the B tile
    pairs (i_idx[t], j_idx[t]); x: (N, P) padded, mu: (P,), P a multiple
    of block_p.  stats[t] = [max off-diagonal |S| in the valid tile,
    max valid off-diagonal |S| <= lam] (0 when there is none)."""
    N, P = x.shape
    bp = block_p
    nt = P // bp
    i_idx = torch.as_tensor(i_idx, dtype=torch.int64, device=x.device)
    j_idx = torch.as_tensor(j_idx, dtype=torch.int64, device=x.device)
    xt = x.reshape(N, nt, bp)
    mt = mu.reshape(nt, bp)
    a = (xt[:, i_idx, :] - mt[i_idx]).permute(1, 2, 0)   # (B, bp, N)
    b = (xt[:, j_idx, :] - mt[j_idx]).permute(1, 0, 2)   # (B, N, bp)
    S = torch.matmul(a, b) / n_true
    iota = torch.arange(bp, device=x.device)
    rows = i_idx[:, None, None] * bp + iota[None, :, None]
    cols = j_idx[:, None, None] * bp + iota[None, None, :]
    valid = (rows < p_true) & (cols < p_true) & (rows != cols)
    absS = S.abs()
    mask = valid & (absS > lam)  # strict: eq. (4), ties are NOT edges
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    vals = torch.where(mask, S, zero)
    counts = mask.sum(dim=(1, 2)).to(torch.int32)
    stats = torch.stack(
        [
            torch.where(valid, absS, zero).amax(dim=(1, 2)),
            torch.where(valid & ~mask, absS, zero).amax(dim=(1, 2)),
        ],
        dim=1,
    )
    return vals, counts, stats
