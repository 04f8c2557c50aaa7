"""Connected components of the thresholded sample covariance graph.

One contract: labels[i] = component id, canonical = smallest vertex index in
the component.  ``connected_components_host`` is the numpy union-find the
default ``"host"`` screening backend runs (the paper's ``graphconncomp``
role).  ``connected_components_labelprop`` is min-label propagation with
pointer jumping in plain torch on S's device (the ``"jax"`` backend), and
``propagate_labels`` is its fixed-point loop, which the ``threshold_cc``
kernel's hook step plugs into as well (the ``"pallas"`` backend).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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


def propagate_labels(
    hook: Callable[[torch.Tensor], torch.Tensor],
    p: int,
    *,
    device: torch.device,
    max_rounds: int | None = None,
) -> tuple[torch.Tensor, int]:
    """Drive a hook step to a fixed point; returns (int32 labels, rounds).

    Each round is one hook ``l_i <- min(l_i, min_{j ~ i} l_j)`` followed by
    two pointer jumps ``l <- l[l]``.  Labels are always vertex indices of a
    member of one's own component, so a jump is well defined, and the fixed
    point labels every vertex with its component's smallest vertex.  The
    loop stops at the first round that changes nothing, capped after the
    first round at ``max_rounds`` more (``p + 2`` by default) as in the
    reference; each convergence test reads one flag back from the device."""
    if p >= 2**31:
        raise ValueError(f"int32 labels cover p < 2**31 vertices, got p={p}")
    if p == 0:
        return torch.zeros(0, dtype=torch.int32, device=device), 0

    def round_(labels: torch.Tensor) -> torch.Tensor:
        labels = hook(labels)
        labels = labels[labels]
        return labels[labels]

    prev = torch.arange(p, dtype=torch.int32, device=device)
    labels, rounds = round_(prev), 1
    limit = p + 2 if max_rounds is None else max_rounds
    while rounds <= limit and bool((labels != prev).any()):
        labels, prev = round_(labels), labels
        rounds += 1
    return labels, rounds


def connected_components_labelprop(S: torch.Tensor, lam: float) -> torch.Tensor:
    """Min-label propagation with pointer jumping, fused with thresholding,
    in plain torch on S's device; returns int32 labels (canonical at the
    fixed point).  The (p, p) mask |S_ij| > lam, i != j, is formed once."""
    p = S.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=S.device)
    mask = (S.abs() > lam) & ~eye
    big = torch.tensor(p, dtype=torch.int32, device=S.device)

    def hook(labels: torch.Tensor) -> torch.Tensor:
        neigh = torch.where(mask, labels[None, :], big)
        return torch.minimum(labels, neigh.amin(dim=1))

    labels, _ = propagate_labels(hook, p, device=S.device)
    return labels


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


def is_refinement(fine: np.ndarray, coarse: np.ndarray) -> bool:
    """Theorem-2 nestedness: every class of ``fine`` lies inside one class
    of ``coarse`` (fine = larger lambda, coarse = smaller lambda)."""
    fine = canonicalize_labels(fine)
    coarse = np.asarray(coarse)
    for lab in np.unique(fine):
        members = coarse[fine == lab]
        if not np.all(members == members[0]):
            return False
    return True


def component_lists(labels: np.ndarray) -> list[np.ndarray]:
    """Members per component, largest first (scheduling order)."""
    labels = canonicalize_labels(labels)
    order = np.argsort(labels, kind="stable")  # stable: members stay ascending
    _, starts = np.unique(labels[order], return_index=True)
    comps = np.split(order, starts[1:])
    return sorted(comps, key=lambda c: -len(c))
