"""Edge-sorted merge profile of the thresholded covariance graph.

The components change *only* at the distinct values of |S_ij| (paper
Section 4.2), so one pass of incremental union-find over edges sorted by
decreasing |S_ij| yields the partition at every threshold.  ``merge_profile``
calibrates the synthetic experiments' lambda interval;
``labels_at_thresholds`` is the path planner's single partition pass;
``component_size_distribution`` the paper's Figure-1 histograms from it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.components import _find, canonicalize_labels
from repro_torch.core.instrument import bump


def _sorted_edges(S: np.ndarray, *, lam_min: float | None = None):
    """Upper-triangle edges of |S| sorted by decreasing weight; edges with
    |S_ij| <= ``lam_min`` are dropped before the sort."""
    S = np.asarray(S)
    p = S.shape[0]
    iu, ju = np.triu_indices(p, 1)
    w = np.abs(S[iu, ju])
    if lam_min is not None:
        keep = w > lam_min
        iu, ju, w = iu[keep], ju[keep], w[keep]
    order = np.argsort(-w, kind="stable")
    return iu[order], ju[order], w[order]


def _profile(p: int, iu, ju, w, *, stop_above: int | None = None) -> dict:
    """The merge profile of a pre-sorted edge list (iu, ju, w descending);
    with ``stop_above`` it ends at the first row whose max_comp exceeds
    that size."""
    parent = np.arange(p)
    size = np.ones(p, dtype=np.int64)
    values = [np.inf]
    n_components = [p]
    max_comp = [1]
    ncomp, mx = p, 1
    k = 0
    m = w.size
    while k < m:
        v = w[k]
        while k < m and w[k] == v:
            ra, rb = _find(parent, iu[k]), _find(parent, ju[k])
            if ra != rb:
                if size[ra] < size[rb]:
                    ra, rb = rb, ra
                parent[rb] = ra
                size[ra] += size[rb]
                ncomp -= 1
                mx = max(mx, int(size[ra]))
            k += 1
        values.append(float(v))
        n_components.append(ncomp)
        max_comp.append(mx)
        if stop_above is not None and mx > stop_above:
            break
    return {
        "value": np.asarray(values),
        "n_components": np.asarray(n_components),
        "max_comp": np.asarray(max_comp),
    }


def merge_profile(S: np.ndarray, *, max_edges: int | None = None) -> dict:
    """Incremental-union merge profile.

    One row per *distinct* edge value v (descending): ``value`` v,
    ``n_components`` and ``max_comp`` of the graph with edges
    {|S_ij| > lambda}, valid for lambda in [next smaller v, v).  Row 0 is
    the all-isolated regime (value=+inf)."""
    bump("partition.unionfind_passes")
    S = np.asarray(S)
    iu, ju, w = _sorted_edges(S)
    if max_edges is not None:
        iu, ju, w = iu[:max_edges], ju[:max_edges], w[:max_edges]
    return _profile(S.shape[0], iu, ju, w)


def _edges_above_floor(A: np.ndarray, k: int):
    """The edges of the upper triangle ``A`` (|S| with the rest zeroed)
    that lie strictly above its (k+1)-th largest value, sorted by
    decreasing weight, and that value (the floor)."""
    flat = A.reshape(-1)
    at = flat.size - k - 1
    floor = float(np.partition(flat, at)[at])
    idx = np.flatnonzero(flat > floor)
    w = flat[idx]
    order = np.argsort(-w, kind="stable")
    iu, ju = np.divmod(idx[order], A.shape[0])
    return (iu, ju, w[order]), floor


def lambda_for_max_component(S: np.ndarray, p_max: int) -> float:
    """Smallest lambda whose maximal thresholded component has size
    <= p_max (paper consequence 5): the largest edge value whose insertion
    pushes max_comp beyond p_max (at lambda = v that edge is excluded).

    At large p the walk starts from the strongest edges: those above the
    (k+1)-th largest |S_ij|, k from 16 p up by 4x.  Their profile is the
    full profile's first rows, so once it exceeds p_max the answer is the
    full profile's, exactly; only when no positive floor gets there is the
    whole upper triangle walked."""
    bump("partition.unionfind_passes")
    S = np.asarray(S)
    p = S.shape[0]
    n_edges = p * (p - 1) // 2
    k = 16 * p
    if k < n_edges:
        A = np.abs(S)
        for i in range(p):  # keep the strict upper triangle, in place
            A[i, : i + 1] = 0.0
        while k < n_edges:
            edges, floor = _edges_above_floor(A, k)
            if floor <= 0.0:
                break
            prof = _profile(p, *edges, stop_above=p_max)
            bad = np.nonzero(prof["max_comp"] > p_max)[0]
            if bad.size:
                return float(prof["value"][bad[0]])
            k *= 4
        del A
    prof = _profile(p, *_sorted_edges(S), stop_above=p_max)
    bad = np.nonzero(prof["max_comp"] > p_max)[0]
    return float(prof["value"][bad[0]]) if bad.size else 0.0


def labels_at_thresholds(S: np.ndarray, lambdas, *, edges=None) -> list[np.ndarray]:
    """Canonical component labels at every requested lambda from ONE
    incremental union-find pass over the edge-sorted |S_ij| (Theorem 2),
    aligned with the input order of ``lambdas``."""
    S = np.asarray(S)
    edges = _sorted_edges(S) if edges is None else edges
    return labels_at_thresholds_from_edges(S.shape[0], lambdas, edges)


def labels_at_thresholds_from_edges(
    p: int, lambdas, edges
) -> list[np.ndarray]:
    """The snapshot pass of ``labels_at_thresholds`` on a pre-sorted edge
    list (iu, ju, w descending)."""
    from repro_torch.core.components import canonicalize_labels

    bump("partition.unionfind_passes")
    iu, ju, w = edges
    parent = np.arange(p)
    lams = np.asarray(list(lambdas), dtype=np.float64).ravel()
    out: list[np.ndarray | None] = [None] * lams.size
    k, m = 0, w.size
    for pos in np.argsort(-lams, kind="stable"):
        lam = lams[pos]
        while k < m and w[k] > lam:  # strict: eq. (4)
            ra, rb = _find(parent, int(iu[k])), _find(parent, int(ju[k]))
            if ra != rb:
                parent[rb if ra < rb else ra] = min(ra, rb)
            k += 1
        roots = np.fromiter((_find(parent, i) for i in range(p)), np.int64, p)
        out[pos] = canonicalize_labels(roots)
    return out  # type: ignore[return-value]


def component_size_distribution(S: np.ndarray, lambdas) -> list[dict]:
    """Figure-1 data: for each lambda, the histogram of component sizes
    ({lambda, sizes, counts, n_components, max_comp}), from ONE union-find
    pass over the sorted edges (``labels_at_thresholds``)."""
    out = []
    for lam, labels in zip(np.asarray(lambdas), labels_at_thresholds(S, lambdas)):
        _, counts = np.unique(labels, return_counts=True)
        sizes, freq = np.unique(counts, return_counts=True)
        out.append(
            {
                "lambda": float(lam),
                "sizes": sizes,
                "counts": freq,
                "n_components": int(counts.size),
                "max_comp": int(counts.max()),
            }
        )
    return out
