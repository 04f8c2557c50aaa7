"""Out-of-core hybrid screening: joint partitions straight from the Xs.

The dense hybrid rule (``repro_torch.joint.screen``) needs, per pair
(i, j), the whole K-vector of covariances — but only for pairs that can
possibly be edges, and BOTH penalties share a per-class necessary
condition: if |S_k,ij| <= lam1 for every class, the pair is screened out
(group: every soft-threshold is zero; fused: |sum_A s| <= sum_A |s_k| <=
|A| lam1 bounds every subset).  So the streamed screen is

  1. PER-CLASS STREAM   each class runs the single-class out-of-core
     machinery at lam1 on the engine's device — chunked moments, per-class
     Cauchy-Schwarz tile skip, the ``covgram_screen`` kernel over its own
     kept-tile schedule (``kernels.covgram_screen.
     covgram_screen_tiles_stacked``) — emitting SIGNED (i, j, S_k,ij)
     candidates;
  2. COMPLETE           on the host: the candidate set is the union over
     classes; for a candidate a class did NOT emit, its exact value is
     recomputed from that class's centered columns (one O(n_k) dot per
     missing value);
  3. DECIDE             the exact hybrid rule (``screen.pair_excess``) on
     every candidate's K-vector — the dense path's arithmetic, so ties
     |S_k,ij| == lam1 resolve identically;
  4. PARTITION          surviving union edges feed the host
     ``stream.unionfind``;
  5. MATERIALIZE        per class, the per-component covariance blocks of
     the union partition, computed on the device (``stream.materialize``)
     — the gather protocol then feeds the joint planner, classifier and
     executor unchanged.

No class's dense (p, p) covariance ever exists.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.instrument import bump
from repro_torch.engine.options import resolve_device
from repro_torch.joint.screen import JointScreenStats, _check_penalty, pair_excess
from repro_torch.kernels.covgram_screen import covgram_screen_tiles_stacked, pad_for_screen
from repro_torch.stream.config import StreamConfig, as_config
from repro_torch.stream.materialize import MaterializedCovariance, materialize_components
from repro_torch.stream.tiler import column_moments, tile_maxima, tile_pair_schedule
from repro_torch.stream.unionfind import StreamingUnionFind


@dataclass
class JointStreamScreen:
    """Everything the joint engine needs, and nothing dense."""

    p: int
    K: int
    lam1: float
    lam2: float
    penalty: str
    labels: np.ndarray
    stats: JointScreenStats
    candidates: tuple                 # (i, j, vals (K, E)) — the hybrid inputs
    S: list[MaterializedCovariance] | None
    moments: list
    config: StreamConfig
    seconds: float


def _complete_candidates(
    X: np.ndarray, mu: np.ndarray, keys: np.ndarray, have_keys: np.ndarray,
    have_vals: np.ndarray, p: int,
) -> np.ndarray:
    """Exact per-class values on the candidate set: emitted values are
    scattered in, missing ones recomputed from the centered columns with
    the estimator's own arithmetic (bit-identical on exactly-representable
    data)."""
    vals = np.zeros(keys.size, dtype=np.float64)
    filled = np.zeros(keys.size, dtype=bool)
    if have_keys.size:
        pos = np.searchsorted(keys, have_keys)
        vals[pos] = have_vals
        filled[pos] = True
    missing = np.flatnonzero(~filled)
    if missing.size:
        mi = (keys[missing] // p).astype(np.int64)
        mj = (keys[missing] % p).astype(np.int64)
        cols, inv = np.unique(np.concatenate([mi, mj]), return_inverse=True)
        Xc = X[:, cols].astype(np.float64) - mu[cols]
        pi = inv[: mi.size]
        pj = inv[mi.size :]
        vals[missing] = np.einsum(
            "ne,ne->e", Xc[:, pi], Xc[:, pj]
        ) / X.shape[0]
    return vals


def joint_stream_screen(
    Xs,
    lam1: float,
    lam2: float,
    *,
    penalty: str = "group",
    config=None,
    materialize: bool = True,
    device="cuda",
) -> JointStreamScreen:
    """Screen (X_1..X_K, lam1, lam2) out-of-core; see the module docstring.

    ``device`` is where the tiles and blocks are computed (``"cuda"`` by
    default, which raises without CUDA; ``"cpu"`` runs the plain version),
    in float64 whatever the Xs' dtype."""
    from repro_torch.stream.screen import _tile_fn

    _check_penalty(penalty)
    cfg = as_config(config)
    dev = resolve_device(device)
    tile_fn = _tile_fn(cfg.backend, dev)
    t0 = time.perf_counter()
    Xs = [X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X) for X in Xs]
    p = Xs[0].shape[1]
    if any(X.shape[1] != p for X in Xs):
        raise ValueError("all classes must share the variable dimension p")
    K = len(Xs)
    lam1 = float(lam1)
    lam2 = float(lam2)
    bump("joint.screens")

    moments = [column_moments(X, chunk=cfg.chunk) for X in Xs]
    xs_dev, xs_pad, mus_pad, schedules_i, schedules_j = [], [], [], [], []
    tiles_total = tiles_skipped = 0
    for X, mom in zip(Xs, moments):
        norms_max = tile_maxima(mom.norms, cfg.tile)
        ti, tj, keep = tile_pair_schedule(norms_max, lam1, slack=cfg.skip_slack)
        tiles_total += int(ti.size)
        tiles_skipped += int((~keep).sum())
        # X goes to the device once, promoted to float64 as in stream_screen
        x_dev = torch.as_tensor(X).to(device=dev, dtype=torch.float64)
        x_pad, mu_pad = pad_for_screen(x_dev, mom.mu, block_n=cfg.chunk, block_p=cfg.tile)
        xs_dev.append(x_dev)
        xs_pad.append(x_pad)
        mus_pad.append(mu_pad)
        schedules_i.append(ti[keep].astype(np.int32))
        schedules_j.append(tj[keep].astype(np.int32))
    bump("stream.tiles_total", tiles_total)
    bump("stream.tiles_skipped", tiles_skipped)

    per_class = covgram_screen_tiles_stacked(
        xs_pad,
        mus_pad,
        schedules_i,
        schedules_j,
        lam1,
        n_trues=[X.shape[0] for X in Xs],
        p_true=p,
        block_p=cfg.tile,
        pair_batch=cfg.resolved_pair_batch(8),
        tile_fn=tile_fn,
    )
    del xs_pad, mus_pad
    bump("stream.edges_emitted", sum(v.size for _, _, v in per_class))

    # candidate union + exact completion per class
    key_parts = [gi * p + gj for gi, gj, _ in per_class]
    keys = (
        np.unique(np.concatenate(key_parts))
        if key_parts
        else np.empty(0, np.int64)
    )
    bump("joint.candidate_pairs", int(keys.size))
    vals = np.zeros((K, keys.size), dtype=np.float64)
    for k, ((gi, gj, v), mom) in enumerate(zip(per_class, moments)):
        vals[k] = _complete_candidates(
            Xs[k], mom.mu, keys, gi * p + gj, v, p
        )

    ci = (keys // p).astype(np.int64)
    cj = (keys % p).astype(np.int64)
    edge = pair_excess(vals, lam1, lam2, penalty=penalty) > 0.0
    n_edges = int(edge.sum())
    bump("joint.edges", n_edges)

    uf = StreamingUnionFind(p)
    uf.union_edges(ci[edge], cj[edge])
    labels = uf.labels()

    _, counts = np.unique(labels, return_counts=True)
    stats = JointScreenStats(
        lam1=lam1,
        lam2=lam2,
        penalty=penalty,
        K=K,
        n_components=int(counts.size),
        max_comp=int(counts.max()),
        n_isolated=int((counts == 1).sum()),
        n_edges=n_edges,
        seconds=time.perf_counter() - t0,
        candidate_pairs=int(keys.size),
        tiles_total=tiles_total,
        tiles_skipped=tiles_skipped,
    )

    S = None
    if materialize:
        S = [
            materialize_components(
                x_dev, torch.as_tensor(mom.mu).to(dev), mom.diag, labels
            )
            for x_dev, mom in zip(xs_dev, moments)
        ]
    stats.seconds = time.perf_counter() - t0
    return JointStreamScreen(
        p=p,
        K=K,
        lam1=lam1,
        lam2=lam2,
        penalty=penalty,
        labels=labels,
        stats=stats,
        candidates=(ci, cj, vals),
        S=S,
        moments=moments,
        config=cfg,
        seconds=stats.seconds,
    )
