"""The paper's screening rule as a standalone, solver-agnostic layer.

``thresholded_components(S, lam)`` is the entire Theorem-1 wrapper interface:
threshold |S| at lambda (strict, off-diagonal — eq. (4)), take connected
components, and the returned vertex partition is *exactly* the partition of
the glasso solution's concentration graph.

The streaming screener (``repro_torch.stream``) produces the same
ScreenStats from X without a dense S; its extra counters (tiles scheduled
and skipped, edges emitted, peak bytes) ride along in the optional fields.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ScreenStats:
    lam: float
    n_components: int
    max_comp: int
    n_isolated: int
    n_edges: int
    seconds: float      # the paper's "graph partition" column
    # streaming-screener provenance (zero for dense screens):
    tiles_total: int = 0     # upper-triangular tile pairs in the schedule
    tiles_skipped: int = 0   # pairs the Cauchy-Schwarz bound pruned
    edges_emitted: int = 0   # compacted edges streamed (|S_ij| > grid min)
    bytes_peak: int = 0      # screening-stage high-watermark (bytes)


def thresholded_components(
    S: np.ndarray, lam: float, *, backend: str = "host", **backend_opts
) -> tuple[np.ndarray, ScreenStats]:
    """Labels of the thresholded sample covariance graph + timing stats.

    ``backend`` names a registered screening backend
    (``repro_torch.engine.registry``): ``"host"`` is the numpy union-find,
    ``"jax"`` plain-torch label propagation on the engine's device and
    ``"pallas"`` the ``threshold_cc`` CUDA hook step driven to a fixed
    point (the reference's backend names).  ``backend_opts`` reach the
    backend (``device=`` for the two device backends).  A device backend
    copies S to its device once and counts the stats' edges there, on the
    same copy (inside ``seconds``, with the copy); for the host backend the
    count reads S on the host after the labels."""
    from repro_torch.engine import registry  # lazy: import cycle

    t0 = time.perf_counter()
    labels, n_edges = registry.screen_components(S, lam, backend=backend, **backend_opts)
    dt = time.perf_counter() - t0
    return labels, screen_stats_from_labels(S, lam, labels, seconds=dt, n_edges=n_edges)


def count_edges(S: np.ndarray, lam: float, *, row_chunk: int = 2048) -> int:
    """Strict upper-triangle edge count of |S| > lam, chunked over row
    blocks so the only temporaries are (row_chunk, p).  A tensor is counted
    on its own device."""
    if hasattr(S, "gather_block"):
        raise TypeError(
            "count_edges needs a dense S; streamed covariances carry their "
            "edge counts (pass n_edges= to screen_stats_from_labels)"
        )
    if isinstance(S, torch.Tensor):
        p = S.shape[0]
        cols = torch.arange(p, device=S.device)
        total = torch.zeros((), dtype=torch.int64, device=S.device)
        for r0 in range(0, p, row_chunk):
            blk = S[r0 : r0 + row_chunk]
            rows = torch.arange(r0, r0 + blk.shape[0], device=S.device)
            total += ((blk.abs() > lam) & (cols[None, :] > rows[:, None])).sum()
        return int(total)
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
    n_edges: int | None = None,
) -> ScreenStats:
    """``n_edges``, when the caller already knows it (streamed edge
    counts), skips touching S entirely — required for materialized
    (block-only) covariances."""
    if n_edges is None:
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
