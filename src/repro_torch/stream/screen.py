"""The out-of-core screen: Theorem-1 partitions straight from X.

``stream_screen(X, lambdas)`` computes, without ever materializing the
(p, p) covariance:

  1. MOMENTS   one chunked numpy pass over X -> mu, S_ii, column norms;
  2. SCHEDULE  upper-triangular column-tile pairs, minus every pair the
               Cauchy-Schwarz bound  max_I sqrt(S_ii) * max_J sqrt(S_jj)
               <= min(lambdas)  proves edge-free (``stream.tiles_skipped``);
  3. STREAM    X goes to the device once; surviving pairs flow in bounded
               batches through the fused ``covgram_screen`` kernel (its
               plain version on the CPU), and each batch compacts on the
               device to (i, j, |S_ij|) triples — only those leave the card;
  4. SNAPSHOT  the retained edges, sorted once, replay the nested Theorem-2
               sweep (``labels_at_thresholds_from_edges``) — one union-find
               pass labeling every requested lambda, the coarsest included;
  5. MATERIALIZE  per-component covariance blocks of the coarsest partition
               are computed from X on the device.

Peak memory is  O(n * p + pair_batch * tile^2 + #edges), recorded in the
``stream.bytes_peak`` watermark; the emitted partition equals
``thresholded_components`` on a dense S, ties included.

Counters (repro_torch.core.instrument):
    stream.tiles_total      upper-triangular tile pairs scheduled
    stream.tiles_skipped    pairs the Cauchy-Schwarz bound pruned
    stream.edges_emitted    compacted edges (|S_ij| > grid minimum)
    stream.bytes_peak       screening-stage high-watermark (bytes)
    stream.deferred_*       oversize components kept as columns, and the
                            gathers they served (``stream.materialize``)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.instrument import bump, set_peak
from repro_torch.core.partition import labels_at_thresholds_from_edges
from repro_torch.core.screening import ScreenStats
from repro_torch.engine.options import resolve_device
from repro_torch.kernels.covgram_screen import (
    compact_edges,
    covgram_screen_ref,
    covgram_screen_tiles,
    pad_for_screen,
)
from repro_torch.stream.accumulate import EdgeAccumulator
from repro_torch.stream.config import StreamConfig, as_config
from repro_torch.stream.materialize import MaterializedCovariance, materialize_components
from repro_torch.stream.tiler import (
    Moments,
    column_moments,
    tile_maxima,
    tile_pair_schedule,
)


@dataclass
class StreamScreen:
    """Everything downstream stages need, and nothing dense."""

    p: int
    n: int
    lambdas: list[float]                    # descending
    labels: list[np.ndarray]                # per lambda, canonical
    stats: list[ScreenStats]                # per lambda
    edges: tuple                            # (i, j, w) sorted by w descending
    S: MaterializedCovariance | None
    moments: Moments
    config: StreamConfig
    seconds: float
    tiles: dict = field(default_factory=dict)   # (ti, tj) -> TileRecord
    tiles_total: int = 0
    tiles_skipped: int = 0


def _tile_fn(backend: str, device: torch.device):
    """The covgram_screen function for a config backend on a device."""
    if backend == "ref":
        return covgram_screen_ref
    if backend == "pallas" and device.type != "cuda":
        raise RuntimeError(
            f"stream backend 'pallas' is the CUDA kernel; the screen runs on {device}"
        )
    return covgram_screen_tiles


def stream_screen(
    X,
    lambdas,
    *,
    config=None,
    keep_tile_stats: bool = False,
    materialize: bool = True,
    device="cuda",
    oversize: int | None = None,
) -> StreamScreen:
    """Screen (X, every lambda) out-of-core; see the module docstring.

    ``device`` is where the tiles are computed (``"cuda"`` by default,
    which raises without CUDA; ``"cpu"`` runs the plain version), in
    float64 whatever X's dtype.  ``oversize`` is the planner's
    single-device block-size cap: components larger than it are
    materialized DEFERRED (no block — the sharded route computes them
    chunk-wise onto the device via ``materialize.shard_gather``)."""
    from repro_torch.select.grid import normalize_lambda_grid

    cfg = as_config(config)
    dev = resolve_device(device)
    tile_fn = _tile_fn(cfg.backend, dev)
    t0 = time.perf_counter()
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    n, p = X.shape
    lams = normalize_lambda_grid(lambdas)
    lam_min = lams[-1]

    moments = column_moments(X, chunk=cfg.chunk)
    norms_max = tile_maxima(moments.norms, cfg.tile)
    ti, tj, keep = tile_pair_schedule(norms_max, lam_min, slack=cfg.skip_slack)
    bump("stream.tiles_total", int(ti.size))
    bump("stream.tiles_skipped", int((~keep).sum()))

    acc = EdgeAccumulator(keep_tiles=keep_tile_stats)
    acc.add_skipped(zip(ti[~keep], tj[~keep]))

    # the kernel computes in float64, as the materialized blocks and the
    # dense estimators do: lower-precision or integer X is promoted first
    x_dev = torch.as_tensor(X).to(device=dev, dtype=torch.float64)
    x_pad, mu_pad = pad_for_screen(x_dev, moments.mu, block_n=cfg.chunk, block_p=cfg.tile)
    batch = cfg.resolved_pair_batch(x_pad.element_size())
    i_keep = ti[keep].astype(np.int32)
    j_keep = tj[keep].astype(np.int32)
    # the schedule goes to the device once: a kernel call is then one launch
    i_dev = torch.from_numpy(i_keep).to(dev)
    j_dev = torch.from_numpy(j_keep).to(dev)
    base_bytes = x_pad.numel() * x_pad.element_size() + 4 * p * 8  # padded X + moments
    local_peak = base_bytes
    for b0 in range(0, i_keep.size, batch):
        sl = slice(b0, b0 + batch)
        bi, bj = i_keep[sl], j_keep[sl]
        vals, _, stats = tile_fn(
            x_pad, mu_pad, i_dev[sl], j_dev[sl], lam_min, n_true=n, p_true=p, block_p=cfg.tile
        )
        gi, gj, w = compact_edges(vals, i_dev[sl], j_dev[sl], block_p=cfg.tile)
        acc.add_batch(bi, bj, gi, gj, w, stats.cpu().numpy(), tile=cfg.tile)
        vals_bytes = vals.numel() * vals.element_size()
        local_peak = max(local_peak, base_bytes + vals_bytes + acc.bytes_held())
        set_peak("stream.bytes_peak", local_peak)
        del vals
    bump("stream.edges_emitted", acc.n_edges)

    ei, ej, ew = acc.edges()
    order = np.argsort(-ew, kind="stable")
    edges = (ei[order], ej[order], ew[order])
    labels = labels_at_thresholds_from_edges(p, lams, edges)

    seconds = time.perf_counter() - t0
    per_lam = seconds / max(len(lams), 1)
    stats_list = []
    for lam, lab in zip(lams, labels):
        _, counts = np.unique(lab, return_counts=True)
        stats_list.append(
            ScreenStats(
                lam=lam,
                n_components=int(counts.size),
                max_comp=int(counts.max()),
                n_isolated=int((counts == 1).sum()),
                # edges sorted descending; strict |S_ij| > lam (eq. (4))
                n_edges=int(np.searchsorted(-edges[2], -lam, side="left")),
                seconds=per_lam,
                tiles_total=int(ti.size),
                tiles_skipped=int((~keep).sum()),
                edges_emitted=acc.n_edges,
                bytes_peak=0,  # filled below once materialization lands
            )
        )

    S = None
    if materialize:
        # the coarsest partition is the grid-minimum snapshot of the same
        # Theorem-2 sweep (lams is descending, so labels[-1]); every finer
        # plan gathers sub-blocks of these blocks
        S = materialize_components(
            x_dev, torch.as_tensor(moments.mu).to(dev), moments.diag, labels[-1],
            oversize=oversize,
        )
        local_peak = max(local_peak, base_bytes + acc.bytes_held() + S.nbytes())
        set_peak("stream.bytes_peak", local_peak)
    for st in stats_list:
        st.bytes_peak = local_peak
    seconds = time.perf_counter() - t0
    return StreamScreen(
        p=p,
        n=n,
        lambdas=lams,
        labels=labels,
        stats=stats_list,
        edges=edges,
        S=S,
        moments=moments,
        config=cfg,
        seconds=seconds,
        tiles=acc.tiles,
        tiles_total=int(ti.size),
        tiles_skipped=int((~keep).sum()),
    )
