"""Incremental re-screening for growing datasets (rank-k covariance updates).

A ``DataSession`` pins one evolving (X, lambda) problem.  Appending k rows Y
perturbs every covariance entry, but bounded-ly:  with G = X'X, n' = n + k,

    S' - S = G (1/n' - 1/n) + Y'Y/n' + (mu mu' - mu~ mu~')

so  |S'_ij - S_ij| <= delta_IJ  per column-tile pair, where delta_IJ is
assembled from per-tile maxima of the uncentered column norms sqrt(G_ii),
the update's column norms, and the mean shift — all O(p) statistics.  A tile
pair whose previous screen left the certificate interval

    [max |S_ij| <= lam  (max_below),  min edge weight  (min_above)]

still clear of lambda after widening by delta provably kept its EDGE SET
(weights moved, no entry crossed the strict eq.-(4) threshold), so the
partition needs nothing from it; only pairs whose certificate broke are
recomputed, by the ``covgram_screen`` kernel on the session's device
(``stream.tiles_rescreened`` vs ``stream.tiles_revalidated``).  Skipped
pairs re-validate even more cheaply against the fresh Cauchy-Schwarz norm
bound.  Certificates SHRINK by delta on every kept update, so stacked
appends stay conservative.

The union-find is rebuilt from the per-tile edge sets (merges AND splits are
handled — an edge can disappear), components touched by recomputed tiles are
reported for plan invalidation, and the per-component blocks are
re-materialized exactly from the updated X on the device — stale weights
never reach a solver.  Sessions are single-lambda by construction (the
serving admission path is per-request anyway); the full-grid path planner
re-screens instead.  A copy of the reference package's ``DataSession``,
with X kept on the session's device between appends.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.instrument import bump
from repro_torch.core.screening import ScreenStats
from repro_torch.engine.options import resolve_device
from repro_torch.kernels.covgram_screen import compact_edges, pad_for_screen
from repro_torch.obs.trace import span
from repro_torch.stream.accumulate import bin_edges_to_records
from repro_torch.stream.config import as_config
from repro_torch.stream.materialize import MaterializedCovariance, materialize_components
from repro_torch.stream.screen import _tile_fn, stream_screen
from repro_torch.stream.tiler import column_moments, pair_skippable, tile_maxima
from repro_torch.stream.unionfind import StreamingUnionFind


@dataclass
class SessionUpdate:
    """What one ``append_rows`` changed."""

    labels: np.ndarray
    stats: ScreenStats
    S: MaterializedCovariance
    tiles_rescreened: int
    tiles_revalidated: int
    components_touched: int


class DataSession:
    """Streaming screen state for one evolving dataset at one lambda.

    ``device`` is where tiles are re-screened and blocks materialized
    (``"cuda"`` by default, which raises without CUDA; ``"cpu"`` runs the
    plain version), in float64 whatever X's dtype, as ``stream_screen``."""

    def __init__(
        self, X, lam: float, *, config=None, oversize: int | None = None, device="cuda",
    ):
        self.lam = float(lam)
        self.config = as_config(config)
        self.device = resolve_device(device)
        self.X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        # single-device block cap: components past it materialize DEFERRED
        # (sharded route gathers them chunk-wise at solve time)
        self.oversize = oversize
        # append_rows mutates X/moments/tiles/labels as one transaction;
        # concurrent appends (serving exposes sessions to many clients)
        # must serialize or certificates detach from the moments they
        # were computed against
        self._lock = threading.Lock()
        bump("stream.sessions")
        sc = stream_screen(
            self.X, [self.lam], config=self.config, keep_tile_stats=True,
            oversize=oversize, device=self.device,
        )
        self.moments = sc.moments
        self.tiles = sc.tiles            # (ti, tj) -> TileRecord
        self.labels = sc.labels[0]
        self.stats = sc.stats[0]
        self.S = sc.S
        # X as the screen computes on it, kept for the appends
        self._x_dev = torch.as_tensor(self.X).to(device=self.device, dtype=torch.float64)

    # -- delta bound -------------------------------------------------------

    def _tile_deltas(self, Y: np.ndarray, new_moments) -> np.ndarray:
        """Conservative per-tile-pair bound on |S'_ij - S_ij| (module doc)."""
        tile = self.config.tile
        old, new = self.moments, new_moments
        n, k = old.n, Y.shape[0]
        n2 = n + k
        g_old = tile_maxima(old.gram_norms, tile)
        y_norm = tile_maxima(
            np.sqrt((Y.astype(np.float64) ** 2).sum(axis=0)), tile
        )
        mu_old = tile_maxima(np.abs(old.mu), tile)
        mu_new = tile_maxima(np.abs(new.mu), tile)
        dmu = tile_maxima(np.abs(new.mu - old.mu), tile)
        nt = g_old.shape[0]
        ti, tj = np.triu_indices(nt)
        delta = (
            g_old[ti] * g_old[tj] * (1.0 / n - 1.0 / n2)
            + y_norm[ti] * y_norm[tj] / n2
            + dmu[ti] * mu_old[tj]
            + mu_new[ti] * dmu[tj]
        ) * (1.0 + self.config.skip_slack)
        out = np.zeros((nt, nt))
        out[ti, tj] = delta
        return out

    # -- the incremental re-screen ----------------------------------------

    def append_rows(self, Y) -> SessionUpdate:
        """Absorb k new data rows; re-screen only the tiles whose
        certificate the perturbation bound cannot clear.  Thread-safe:
        concurrent appends serialize on the session lock."""
        Y = Y.cpu().numpy() if isinstance(Y, torch.Tensor) else np.asarray(Y)
        with self._lock, span(
            "session.append_rows", k=int(np.atleast_2d(Y).shape[0])
        ):
            return self._append_rows_locked(Y)

    def _append_rows_locked(self, Y: np.ndarray) -> SessionUpdate:
        t0 = time.perf_counter()
        Y = np.atleast_2d(Y)
        if Y.shape[1] != self.X.shape[1]:
            raise ValueError(
                f"appended rows have p={Y.shape[1]}, session has "
                f"p={self.X.shape[1]}"
            )
        cfg = self.config
        lam, tile = self.lam, cfg.tile
        X2 = np.concatenate([self.X, Y], axis=0)
        new_moments = column_moments(X2, chunk=cfg.chunk)
        deltas = self._tile_deltas(Y, new_moments)
        norms_max = tile_maxima(new_moments.norms, tile)

        invalid: list[tuple[int, int]] = []
        for (ti, tj), rec in self.tiles.items():
            if rec.skipped:
                # fresh Cauchy-Schwarz bound (the schedule's predicate):
                # still provably edge-free?
                if pair_skippable(
                    norms_max, ti, tj, lam, slack=cfg.skip_slack
                ):
                    continue
                invalid.append((ti, tj))
            else:
                d = deltas[ti, tj]
                if rec.min_above - d > lam and rec.max_below + d <= lam:
                    # certificate holds: edge set unchanged; shrink it so
                    # stacked updates stay conservative
                    rec.min_above -= d
                    rec.max_below += d
                    continue
                invalid.append((ti, tj))

        touched_vertices: set[int] = set()
        for key in invalid:
            rec = self.tiles[key]
            if rec.gi is not None and rec.gi.size:
                touched_vertices.update(rec.gi.tolist())
                touched_vertices.update(rec.gj.tolist())

        n2, p = X2.shape
        dev = self.device
        x_dev = torch.cat(
            [self._x_dev, torch.as_tensor(Y).to(device=dev, dtype=torch.float64)]
        )
        if invalid:
            x_pad, mu_pad = pad_for_screen(
                x_dev, new_moments.mu, block_n=cfg.chunk, block_p=tile
            )
            tile_fn = _tile_fn(cfg.backend, dev)
            batch = cfg.resolved_pair_batch(x_pad.element_size())
            inv_i = np.array([t for t, _ in invalid], dtype=np.int32)
            inv_j = np.array([t for _, t in invalid], dtype=np.int32)
            # the schedule goes to the device once: a kernel call is then
            # one launch
            i_dev = torch.from_numpy(inv_i).to(dev)
            j_dev = torch.from_numpy(inv_j).to(dev)
            for b0 in range(0, inv_i.size, batch):
                sl = slice(b0, b0 + batch)
                vals, _, stats = tile_fn(
                    x_pad, mu_pad, i_dev[sl], j_dev[sl], lam,
                    n_true=n2, p_true=p, block_p=tile,
                )
                gi, gj, w = compact_edges(vals, i_dev[sl], j_dev[sl], block_p=tile)
                fresh = bin_edges_to_records(
                    inv_i[sl], inv_j[sl], gi, gj, w, stats.cpu().numpy(), tile=tile
                )
                self.tiles.update(fresh)
                for rec in fresh.values():
                    if rec.gi.size:
                        touched_vertices.update(rec.gi.tolist())
                        touched_vertices.update(rec.gj.tolist())
                del vals

        bump("stream.tiles_rescreened", len(invalid))
        n_valid = len(self.tiles) - len(invalid)
        bump("stream.tiles_revalidated", n_valid)

        # rebuild the partition from the per-tile edge sets (splits included)
        uf = StreamingUnionFind(p)
        n_edges = 0
        for rec in self.tiles.values():
            if rec.gi is not None and rec.gi.size:
                uf.union_edges(rec.gi, rec.gj)
                n_edges += int(rec.gi.size)
        labels = uf.labels()

        old_labels = self.labels
        touched_roots = {int(labels[v]) for v in touched_vertices} | {
            int(old_labels[v]) for v in touched_vertices
        }
        components_touched = len(touched_roots)
        bump("stream.session_components_touched", components_touched)

        S = materialize_components(
            x_dev, torch.as_tensor(new_moments.mu).to(dev), new_moments.diag, labels,
            oversize=self.oversize,
        )
        _, counts = np.unique(labels, return_counts=True)
        stats = ScreenStats(
            lam=lam,
            n_components=int(counts.size),
            max_comp=int(counts.max()),
            n_isolated=int((counts == 1).sum()),
            n_edges=n_edges,
            seconds=time.perf_counter() - t0,
            tiles_total=len(self.tiles),
            tiles_skipped=sum(1 for r in self.tiles.values() if r.skipped),
            edges_emitted=n_edges,
            bytes_peak=self.stats.bytes_peak,
        )

        self.X, self._x_dev, self.moments = X2, x_dev, new_moments
        self.labels, self.stats, self.S = labels, stats, S
        return SessionUpdate(
            labels=labels,
            stats=stats,
            S=S,
            tiles_rescreened=len(invalid),
            tiles_revalidated=n_valid,
            components_touched=components_touched,
        )
