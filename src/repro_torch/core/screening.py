"""The paper's screening rule as a standalone, solver-agnostic layer.

``thresholded_components(S, lam)`` is the entire Theorem-1 wrapper interface:
threshold |S| at lambda (strict, off-diagonal — eq. (4)), take connected
components, and the returned vertex partition is *exactly* the partition of
the glasso solution's concentration graph.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class ScreenStats:
    lam: float
    n_components: int
    max_comp: int
    n_isolated: int
    n_edges: int
    seconds: float      # the paper's "graph partition" column


def thresholded_components(
    S: np.ndarray, lam: float, *, backend: str = "host", **backend_opts
) -> tuple[np.ndarray, ScreenStats]:
    """Labels of the thresholded sample covariance graph + timing stats.

    ``backend`` names a registered screening backend
    (``repro_torch.engine.registry``); ``"host"`` is the numpy union-find."""
    from repro_torch.engine.registry import label_components  # lazy: import cycle

    t0 = time.perf_counter()
    labels = label_components(S, lam, backend=backend, **backend_opts)
    dt = time.perf_counter() - t0
    return labels, screen_stats_from_labels(S, lam, labels, seconds=dt)


def count_edges(S: np.ndarray, lam: float, *, row_chunk: int = 2048) -> int:
    """Strict upper-triangle edge count of |S| > lam, chunked over row
    blocks so the only temporaries are (row_chunk, p)."""
    Sd = np.asarray(S)
    p = Sd.shape[0]
    cols = np.arange(p)
    n_edges = 0
    for r0 in range(0, p, row_chunk):
        blk = Sd[r0 : r0 + row_chunk]
        upper = cols[None, :] > np.arange(r0, r0 + blk.shape[0])[:, None]
        n_edges += int(((np.abs(blk) > lam) & upper).sum())
    return n_edges


def screen_stats_from_labels(
    S: np.ndarray,
    lam: float,
    labels: np.ndarray,
    *,
    seconds: float,
) -> ScreenStats:
    n_edges = count_edges(S, lam)
    _, counts = np.unique(labels, return_counts=True)
    return ScreenStats(
        lam=float(lam),
        n_components=int(counts.size),
        max_comp=int(counts.max()),
        n_isolated=int((counts == 1).sum()),
        n_edges=int(n_edges),
        seconds=seconds,
    )
