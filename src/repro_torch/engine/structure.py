"""Structure classification of thresholded component subgraphs.

The paper's screening rule hands the executor a bag of independent blocks;
sending every one of them — singletons, pairs, trees — to a full iterative
solver wastes most of the work.  Fattahi & Sojoudi (arXiv:1708.09479) give an exact closed-form
glasso solution when the thresholded support is acyclic, and Fattahi, Zhang
& Sojoudi (arXiv:1711.09131) extend fast recovery to chordal supports via
the maximum-determinant completion; in the large-lambda regime the paper
targets, most components ARE these shapes.  This module is the planner-side
stage that detects them:

    classify_component(S, comp, lam) -> one of STRUCTURES

    "singleton"  |comp| == 1                      -> diagonal formula
    "pair"       |comp| == 2                      -> analytic 2x2
    "tree"       acyclic (|E| == |V| - 1)         -> Fattahi-Sojoudi closed
                                                     form (O(|E|))
    "chordal"    perfect elimination ordering     -> clique-tree direct solve
                 exists (maximum cardinality         (zero-fill sparse
                 search check)                       Cholesky equivalent)
    "general"    everything else                  -> iterative solver ladder
                                                     tail (bcd/pg/admm)

Classification is exact, not heuristic: MCS + the Tarjan-Yannakakis PEO
check decide chordality in O(b^2) for a b-vertex block, negligible next to
even one iterative sweep.  The same adjacency (strict |S_ij| > lam, paper
eq. (4)) feeds both the classifier and the closed-form solvers, so the
routed solver sees exactly the structure it was promised.

Counters (repro_torch.core.instrument):
    structure.classified.<class>   components classified per class
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instrument import bump

#: the routing ladder's structure classes, fastest solver first.  "oversize"
#: is assigned by the PLANNER (size threshold from the device memory budget,
#: checked before any graph classification — running MCS on a giant
#: component would cost more than it could ever save), never by
#: ``classify_component``; it routes to the sharded solver.
STRUCTURES = ("singleton", "pair", "tree", "chordal", "general", "oversize")


def component_adjacency(S: np.ndarray, comp: np.ndarray, lam: float) -> np.ndarray:
    """Boolean adjacency of one component's thresholded subgraph.

    Strict inequality (eq. (4)): ties |S_ij| == lam are NOT edges — the same
    convention every screening backend and closed-form solver uses."""
    from repro_torch.core.blocks import gather_submatrix

    blk = np.abs(gather_submatrix(S, np.asarray(comp))) > lam
    np.fill_diagonal(blk, False)
    return blk


def mcs_elimination_order(adj: np.ndarray) -> np.ndarray:
    """Maximum cardinality search elimination order.

    Returns ``order`` with ``order[k]`` = vertex eliminated k-th.  Vertices
    are numbered from the back by repeatedly taking an unnumbered vertex
    with the most numbered neighbors (ties -> smallest index, so the order
    is deterministic).  For a chordal graph the result is a perfect
    elimination ordering (Tarjan & Yannakakis 1984)."""
    b = adj.shape[0]
    weight = np.zeros(b, dtype=np.int64)
    numbered = np.zeros(b, dtype=bool)
    order = np.empty(b, dtype=np.int64)
    for k in range(b - 1, -1, -1):
        cand = np.flatnonzero(~numbered)
        v = int(cand[np.argmax(weight[cand])])
        order[k] = v
        numbered[v] = True
        weight[adj[v] & ~numbered] += 1
    return order


def is_perfect_elimination_order(adj: np.ndarray, order: np.ndarray) -> bool:
    """Tarjan-Yannakakis check: for each vertex, its later neighbors must
    all be adjacent to the earliest of them."""
    b = adj.shape[0]
    pos = np.empty(b, dtype=np.int64)
    pos[order] = np.arange(b)
    for i in range(b):
        v = int(order[i])
        later = np.flatnonzero(adj[v] & (pos > i))
        if later.size <= 1:
            continue
        u = int(later[np.argmin(pos[later])])
        rest = later[later != u]
        if not adj[u, rest].all():
            return False
    return True


def peo_or_none(adj: np.ndarray) -> np.ndarray | None:
    """A perfect elimination ordering of ``adj``, or None if not chordal."""
    order = mcs_elimination_order(adj)
    return order if is_perfect_elimination_order(adj, order) else None


def clique_tree(
    adj: np.ndarray, order: np.ndarray
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Maximal cliques and clique-tree separators of a chordal graph.

    Given a PEO, candidate cliques are ``{v} + later-neighbors(v)``;
    non-maximal candidates are dropped, then a maximum-weight spanning tree
    of the clique intersection graph (weight = intersection size) realizes
    the running-intersection property, and its edge intersections are the
    separators — WITH multiplicity, which is what the max-det completion
    inverse formula needs (Vandenberghe & Andersen 2015, eq. Theta =
    sum_C [A_C^{-1}] - sum_S [A_S^{-1}]).

    Separators of a connected component are always non-empty; the graph must
    be connected and chordal (caller's responsibility — the planner only
    calls this on components whose PEO check passed)."""
    b = adj.shape[0]
    pos = np.empty(b, dtype=np.int64)
    pos[order] = np.arange(b)
    cand: list[frozenset[int]] = []
    for i in range(b):
        v = int(order[i])
        later = np.flatnonzero(adj[v] & (pos > i))
        cand.append(frozenset([v]) | frozenset(int(u) for u in later))
    # drop duplicates and non-maximal candidates (k <= b sets, each <= b)
    uniq = sorted(set(cand), key=lambda c: (-len(c), sorted(c)))
    cliques_sets: list[frozenset[int]] = []
    for c in uniq:
        if not any(c < kept for kept in cliques_sets):
            cliques_sets.append(c)
    k = len(cliques_sets)
    cliques = [np.array(sorted(c), dtype=np.int64) for c in cliques_sets]
    if k == 1:
        return cliques, []
    # Prim's maximum-weight spanning tree on pairwise intersection sizes
    in_tree = np.zeros(k, dtype=bool)
    in_tree[0] = True
    best_w = np.array([len(cliques_sets[0] & c) for c in cliques_sets])
    best_from = np.zeros(k, dtype=np.int64)
    separators: list[np.ndarray] = []
    for _ in range(k - 1):
        cand_idx = np.flatnonzero(~in_tree)
        j = int(cand_idx[np.argmax(best_w[cand_idx])])
        sep = cliques_sets[j] & cliques_sets[int(best_from[j])]
        separators.append(np.array(sorted(sep), dtype=np.int64))
        in_tree[j] = True
        for m in cand_idx:
            w = len(cliques_sets[int(m)] & cliques_sets[j])
            if w > best_w[m]:
                best_w[m] = w
                best_from[m] = j
    return cliques, separators


def classify_adjacency(adj: np.ndarray) -> str:
    """Classify one CONNECTED component's adjacency into a structure class."""
    b = adj.shape[0]
    if b == 1:
        return "singleton"
    if b == 2:
        return "pair"
    n_edges = int(adj.sum()) // 2
    if n_edges == b - 1:
        return "tree"  # connected + |E| == |V|-1  <=>  acyclic
    if peo_or_none(adj) is not None:
        return "chordal"
    return "general"


def classify_component(S: np.ndarray, comp: np.ndarray, lam: float) -> str:
    """Structure class of one component of the thresholded graph of (S, lam)."""
    comp = np.asarray(comp)
    if comp.size == 1:
        cls = "singleton"
    else:
        cls = classify_adjacency(component_adjacency(S, comp, lam))
    bump(f"structure.classified.{cls}")
    return cls
