"""Incremental host union-find over unsorted streamed edge batches.

Unlike ``core.partition.labels_at_thresholds`` (one pass over PRE-SORTED
edges — which the screen driver uses, since it retains the full weighted
edge list anyway), this structure absorbs unsorted batches as they arrive
with no sort and no weights: the joint streamed screen
(``repro_torch.joint.stream``) partitions its union edges here, since a
single-threshold screen has no sorted sweep to amortize.  A copy of the
reference package's.
"""

from __future__ import annotations

import numpy as np


class StreamingUnionFind:
    """Union-find over p vertices with batched edge absorption."""

    def __init__(self, p: int):
        self.p = int(p)
        self.parent = np.arange(self.p)
        self.n_components = self.p

    def _find(self, i: int) -> int:
        parent = self.parent
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    def union_edges(self, gi: np.ndarray, gj: np.ndarray) -> int:
        """Absorb one batch of edges; returns the number of merges."""
        merges = 0
        for a, b in zip(gi.tolist(), gj.tolist()):
            ra, rb = self._find(a), self._find(b)
            if ra != rb:
                # union toward the smaller root keeps labels canonical-ish;
                # labels() canonicalizes regardless
                if ra < rb:
                    self.parent[rb] = ra
                else:
                    self.parent[ra] = rb
                merges += 1
        self.n_components -= merges
        return merges

    def labels(self) -> np.ndarray:
        """Canonical labels (labels[i] == smallest vertex in i's component)."""
        from repro_torch.core.components import canonicalize_labels

        roots = np.fromiter(
            (self._find(i) for i in range(self.p)), np.int64, self.p
        )
        return canonicalize_labels(roots)
