"""Host-side edge accumulation for the streaming screener.

Collects the compacted (i, j, |S_ij|) triples each tile batch emits into
growing flat arrays (the O(#edges) term of the memory model) and, on
request (``stream_screen(keep_tile_stats=True)``), a per-tile-pair record
of the bounds needed to re-validate the tile after a rank-k data update
without recomputing it:

    min_above   smallest edge weight in the tile  (> lam by construction)
    max_below   largest off-diagonal |S_ij| <= lam (kernel ``stats[:, 1]``)

A tile whose [max_below + delta, min_above - delta] interval still brackets
lam after an update provably kept its edge SET (weights may be stale, the
partition at lam is not) — what ``DataSession``'s re-screen of appended
data rows checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TileRecord:
    """Per-tile-pair screening outcome retained for re-validation."""

    skipped: bool
    n_edges: int = 0
    min_above: float = np.inf
    max_below: float = 0.0
    # local edge arrays (global vertex ids + |S_ij|); kept only on request
    gi: np.ndarray | None = None
    gj: np.ndarray | None = None
    w: np.ndarray | None = None


def bin_edges_to_records(
    i_idx, j_idx, gi: np.ndarray, gj: np.ndarray, w: np.ndarray,
    stats: np.ndarray, *, tile: int,
) -> dict[tuple[int, int], TileRecord]:
    """Bin one computed batch's compacted edges back to per-tile-pair
    records — THE record constructor (the screen accumulator and the
    incremental re-screen both build certificates here, so the min_above/max_below
    conventions cannot drift apart)."""
    tile_of = gi // tile * np.int64(2**20) + gj // tile
    out: dict[tuple[int, int], TileRecord] = {}
    for t, (ti, tj) in enumerate(zip(i_idx, j_idx)):
        key = np.int64(ti) * np.int64(2**20) + np.int64(tj)
        sel = tile_of == key
        rec = TileRecord(
            skipped=False,
            n_edges=int(sel.sum()),
            max_below=float(stats[t, 1]),
            gi=gi[sel],
            gj=gj[sel],
            w=w[sel],
        )
        rec.min_above = float(rec.w.min()) if rec.n_edges else np.inf
        out[(int(ti), int(tj))] = rec
    return out


@dataclass
class EdgeAccumulator:
    """Growing edge store + optional per-tile records."""

    keep_tiles: bool = False
    chunks_i: list = field(default_factory=list)
    chunks_j: list = field(default_factory=list)
    chunks_w: list = field(default_factory=list)
    tiles: dict = field(default_factory=dict)  # (ti, tj) -> TileRecord
    n_edges: int = 0

    def add_skipped(self, pairs) -> None:
        if self.keep_tiles:
            for ti, tj in pairs:
                self.tiles[(int(ti), int(tj))] = TileRecord(skipped=True)

    def add_batch(
        self,
        i_idx: np.ndarray,
        j_idx: np.ndarray,
        gi: np.ndarray,
        gj: np.ndarray,
        w: np.ndarray,
        stats: np.ndarray,
        *,
        tile: int,
    ) -> None:
        """Absorb one computed batch: global edge triples + kernel stats."""
        if gi.size:
            self.chunks_i.append(gi)
            self.chunks_j.append(gj)
            self.chunks_w.append(w)
            self.n_edges += int(gi.size)
        if not self.keep_tiles:
            return
        self.tiles.update(
            bin_edges_to_records(i_idx, j_idx, gi, gj, w, stats, tile=tile)
        )

    def edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenated (i, j, w), unsorted."""
        if not self.chunks_i:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), np.zeros(0, dtype=np.float64)
        return (
            np.concatenate(self.chunks_i),
            np.concatenate(self.chunks_j),
            np.concatenate(self.chunks_w),
        )

    def bytes_held(self) -> int:
        return sum(
            a.nbytes
            for chunks in (self.chunks_i, self.chunks_j, self.chunks_w)
            for a in chunks
        )
