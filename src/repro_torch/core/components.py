"""Connected components of the thresholded sample covariance graph.

One contract: labels[i] = component id, canonical = smallest vertex index in
the component.  ``connected_components_host`` is the numpy union-find the
default ``"host"`` screening backend runs (the paper's ``graphconncomp``
role).  The reference's device label propagation belongs to its other
backends and comes with the ``threshold_cc`` kernel.
"""

from __future__ import annotations

import numpy as np


def _find(parent: np.ndarray, i: int) -> int:
    root = i
    while parent[root] != root:
        root = parent[root]
    while parent[i] != root:  # path compression
        parent[i], i = root, parent[i]
    return root


def connected_components_host(adj: np.ndarray) -> np.ndarray:
    """Union-find over a boolean adjacency matrix. Returns canonical labels."""
    from repro_torch.core.instrument import bump

    bump("partition.unionfind_passes")
    adj = np.asarray(adj)
    p = adj.shape[0]
    parent = np.arange(p)
    ii, jj = np.nonzero(np.triu(adj, 1))
    for a, b in zip(ii.tolist(), jj.tolist()):
        ra, rb = _find(parent, a), _find(parent, b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    return np.array([_find(parent, i) for i in range(p)])


def threshold_adjacency(S: np.ndarray, lam: float) -> np.ndarray:
    """E_ij = 1[|S_ij| > lambda, i != j]  (paper eq. (4), strict inequality)."""
    A = np.abs(np.asarray(S)) > lam
    np.fill_diagonal(A, False)
    return A


def components_from_covariance_host(S: np.ndarray, lam: float) -> np.ndarray:
    return connected_components_host(threshold_adjacency(S, lam))


def canonicalize_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel so each component's id is its smallest vertex index."""
    labels = np.asarray(labels)
    p = labels.shape[0]
    if p == 0:
        return labels.copy()
    _, inverse = np.unique(labels, return_inverse=True)
    mins = np.full(inverse.max() + 1, p, dtype=np.int64)
    np.minimum.at(mins, inverse, np.arange(p, dtype=np.int64))
    return mins[inverse].astype(labels.dtype, copy=False)


def partitions_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Theorem-1 equality: same vertex partition up to label permutation."""
    return bool(np.array_equal(canonicalize_labels(a), canonicalize_labels(b)))


def component_lists(labels: np.ndarray) -> list[np.ndarray]:
    """Members per component, largest first (scheduling order)."""
    labels = canonicalize_labels(labels)
    order = np.argsort(labels, kind="stable")  # stable: members stay ascending
    _, starts = np.unique(labels[order], return_index=True)
    comps = np.split(order, starts[1:])
    return sorted(comps, key=lambda c: -len(c))
