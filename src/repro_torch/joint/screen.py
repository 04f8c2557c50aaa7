"""Exact hybrid covariance thresholding for the joint graphical lasso.

Tang, Yang, Peng & Xu (arXiv:1503.02128) generalize the source paper's
Theorem 1 to K classes estimated JOINTLY under

    min_{Theta_1..Theta_K}  sum_k [ -logdet Theta_k + tr(S_k Theta_k)
                                    + lam1 ||Theta_k||_1 ]
                            + lam2 * P2({Theta_k})                      (J)

    P2 group:  sum_{i != j} sqrt(sum_k Theta_k,ij^2)
    P2 fused:  sum_{i != j} sum_{k<k'} |Theta_k,ij - Theta_k',ij|

(lam1 penalizes every entry including the diagonal — the single-class
convention of this repo, so lam2 = 0 decouples (J) into K independent
``glasso`` problems exactly; lam2 couples OFF-DIAGONAL entries only).

The screen is per-PAIR but HYBRID across classes: whether (i, j) can carry
an edge in ANY class depends on the whole vector s = (S_1,ij .. S_K,ij).
Writing the zero-subgradient feasibility of (J) at Theta_ij,: = 0:

    group:  exists z in [-1,1]^K, ||c||_2 <= 1 with s_k = lam1 z_k + lam2 c_k
            <=>  sum_k soft(|s_k|, lam1)^2 <= lam2^2                    (G)

    fused:  exists z in [-1,1]^K and antisymmetric y_kk' in [-1,1] with
            s_k = lam1 z_k + lam2 sum_k' y_kk'
            <=>  for every nonempty A subset {1..K}:
                 |sum_{k in A} s_k| <= |A| lam1 + |A|(K-|A|) lam2       (F)
            (max-flow / polymatroid duality: within-A y's cancel in the
            subset sum, each boundary pair contributes at most lam2)

(F) looks exponential but is not: for fixed |A| = m the extreme subset sums
are the m largest and m smallest of s, so sorting s once reduces the check
to K prefix-sum comparisons per pair — ``fused_subset_excess``.  Both
conditions are STRICT-inequality screens like eq. (4): a tie (equality)
is NOT an edge.  With lam2 = 0 both reduce to "any |s_k| > lam1" — the
union of the per-class Theorem-1 screens.

The union graph over all pairs whose condition FAILS partitions the
vertices; Tang et al. prove the joint solution's union support graph
induces EXACTLY this partition, so the joint problem decomposes into
independent per-component joint problems — the K-class Theorem 1.
``joint_thresholded_components`` emits the canonical labels through any
registered cc backend (the union adjacency is fed to ``registry.
label_components`` as a 0/1 matrix thresholded at 1/2), so the host,
"jax" and "pallas" backends all serve the joint screen unchanged.  This
module is numpy, a copy of the reference package's.

This module also owns the union-graph STRUCTURE CLASSIFIER for the joint
routing ladder (``classify_joint_component``); see ``repro_torch.joint.engine``
for how "joint_forest" buckets reach the batched closed-form fast path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.instrument import bump

PENALTIES = ("group", "fused")


def _check_penalty(penalty: str) -> str:
    if penalty not in PENALTIES:
        raise ValueError(f"unknown joint penalty {penalty!r}; available: {PENALTIES}")
    return penalty


def fused_subset_excess(
    vals: np.ndarray, slack: float, lam2: float
) -> np.ndarray:
    """Worst subset-sum violation of the fused feasibility system (F).

    ``vals`` has the class axis FIRST: shape (m, ...).  Returns, per
    trailing position, max over subset sizes mm of

        max( sum of mm largest, -(sum of mm smallest) )
        - ( mm * slack + lam2 * mm * (m - mm) )

    i.e. > 0 iff NO feasible (z, y) exists — for the screen this is the
    edge indicator (slack = lam1); the joint KKT verifier reuses it with
    slack = 0 on tied active groups (``repro_torch.joint.kkt``)."""
    vals = np.asarray(vals, dtype=np.float64)
    m = vals.shape[0]
    srt = np.sort(vals, axis=0)  # ascending
    prefix = np.concatenate(
        [np.zeros((1,) + vals.shape[1:]), np.cumsum(srt, axis=0)], axis=0
    )
    total = prefix[m]
    excess = np.full(vals.shape[1:], -np.inf)
    for mm in range(1, m + 1):
        top = total - prefix[m - mm]      # sum of mm largest
        bot = prefix[mm]                  # sum of mm smallest
        bound = mm * slack + lam2 * mm * (m - mm)
        excess = np.maximum(excess, np.maximum(top, -bot) - bound)
    return excess


def pair_excess(
    vals: np.ndarray, lam1: float, lam2: float, *, penalty: str
) -> np.ndarray:
    """Hybrid-rule violation per pair; > 0 is an edge (strict, ties are not).

    ``vals`` carries the K class values along axis 0 (any trailing shape:
    a (K, p, p) dense stack, or (K, E) candidate columns on the streamed
    path)."""
    _check_penalty(penalty)
    vals = np.asarray(vals, dtype=np.float64)
    if penalty == "group":
        soft = np.maximum(np.abs(vals) - lam1, 0.0)
        return np.einsum("k...,k...->...", soft, soft) - lam2 * lam2
    return fused_subset_excess(vals, lam1, lam2)


def joint_union_adjacency(
    Ss: np.ndarray | list, lam1: float, lam2: float, *, penalty: str
) -> np.ndarray:
    """Boolean union adjacency of the hybrid-thresholded K-class graph."""
    stack = np.stack([np.asarray(S, dtype=np.float64) for S in Ss])
    adj = pair_excess(stack, lam1, lam2, penalty=penalty) > 0.0
    np.fill_diagonal(adj, False)
    return adj & adj.T  # symmetric by construction; belt and braces


@dataclass
class JointScreenStats:
    """Per-screen statistics, the K-class analog of ``ScreenStats``."""

    lam1: float
    lam2: float
    penalty: str
    K: int
    n_components: int
    max_comp: int
    n_isolated: int
    n_edges: int                 # union-graph edges (hybrid rule)
    seconds: float
    # streaming provenance (zero for dense screens):
    candidate_pairs: int = 0     # pairs with |S_k,ij| > lam1 in >= 1 class
    tiles_total: int = 0         # per-class tile pairs scheduled, summed
    tiles_skipped: int = 0       # per-class Cauchy-Schwarz prunes, summed


def _stats_from_labels(
    labels: np.ndarray,
    n_edges: int,
    lam1: float,
    lam2: float,
    penalty: str,
    K: int,
    seconds: float,
) -> JointScreenStats:
    _, counts = np.unique(labels, return_counts=True)
    return JointScreenStats(
        lam1=float(lam1),
        lam2=float(lam2),
        penalty=penalty,
        K=int(K),
        n_components=int(counts.size),
        max_comp=int(counts.max()),
        n_isolated=int((counts == 1).sum()),
        n_edges=int(n_edges),
        seconds=seconds,
    )


def joint_thresholded_components(
    Ss,
    lam1: float,
    lam2: float,
    *,
    penalty: str = "group",
    backend: str = "host",
    **backend_opts,
) -> tuple[np.ndarray, JointScreenStats]:
    """Canonical labels of the hybrid-thresholded union graph + stats.

    ``backend`` names any registered cc backend (host/jax/pallas or
    user-registered; the device backends take ``device=``): the union adjacency is handed to it as a 0/1
    matrix with lam = 1/2, so every backend computes the identical joint
    partition it already computes for the single-class screen."""
    from repro_torch.engine.registry import label_components

    t0 = time.perf_counter()
    bump("joint.screens")
    adj = joint_union_adjacency(Ss, lam1, lam2, penalty=penalty)
    labels = label_components(adj.astype(np.float64), 0.5, backend=backend, **backend_opts)
    n_edges = int(np.triu(adj, 1).sum())
    return labels, _stats_from_labels(
        labels, n_edges, lam1, lam2, penalty, len(Ss), time.perf_counter() - t0
    )


# ---------------------------------------------------------------------------
# Union-graph structure classification (the joint routing ladder's planner
# stage)
# ---------------------------------------------------------------------------

#: joint structure classes.  "singleton" shares the single-class assemble
#: route.  IDENTICAL class blocks reduce the joint problem to ONE
#: single-class problem at an effective lambda (see ``repro_torch.joint.engine``),
#: so they fan out by the union subgraph's shape exactly like the
#: single-class ladder: "joint_forest" (pair/tree -> batched forest closed
#: form), "joint_chordal" (chordal -> host clique-tree direct solve),
#: "joint_shared" (general -> ONE single-class iterative solve instead of a
#: K-coupled one).  Everything else takes the joint ADMM through
#: "joint_general".
JOINT_STRUCTURES = (
    "singleton", "joint_forest", "joint_chordal", "joint_shared",
    "joint_general",
)


def joint_component_adjacency(
    Ss, comp: np.ndarray, lam1: float, lam2: float, *, penalty: str
) -> np.ndarray:
    """Union adjacency of one component's hybrid-thresholded subgraph.

    Goes through the gather protocol (``blocks.gather_submatrix``) per
    class, so materialized streamed covariances classify identically to
    dense stacks."""
    from repro_torch.core.blocks import gather_submatrix

    comp = np.asarray(comp)
    stack = np.stack(
        [gather_submatrix(S, comp, dtype=np.float64) for S in Ss]
    )
    adj = pair_excess(stack, lam1, lam2, penalty=penalty) > 0.0
    np.fill_diagonal(adj, False)
    return adj


def classify_joint_component(
    Ss, comp: np.ndarray, lam1: float, lam2: float, *, penalty: str
) -> str:
    """Structure class of one union component for the joint routing ladder.

    The shared classes require IDENTICAL class blocks (to machine
    precision) — then the joint problem on the component reduces to a
    single-class problem at an effective lambda (see ``repro_torch.joint.engine``)
    and the union subgraph's shape picks the single-class machinery:
    pair/tree -> "joint_forest", chordal -> "joint_chordal", general ->
    "joint_shared".  The identity test is a routing heuristic, not a
    correctness gate: every shared-path candidate is per-class KKT-verified
    against its OWN class block, so a near-identical misclassification
    falls back to the joint ADMM instead of corrupting the answer."""
    from repro_torch.core.blocks import gather_submatrix
    from repro_torch.engine.structure import classify_adjacency

    comp = np.asarray(comp)
    if comp.size == 1:
        bump("structure.classified.singleton")
        return "singleton"
    blocks = [gather_submatrix(S, comp, dtype=np.float64) for S in Ss]
    scale = max(1.0, float(np.abs(blocks[0]).max()))
    identical = all(
        np.allclose(blocks[0], blk, rtol=0.0, atol=1e-12 * scale)
        for blk in blocks[1:]
    )
    cls = "joint_general"
    if identical:
        stack = np.stack(blocks)
        adj = pair_excess(stack, lam1, lam2, penalty=penalty) > 0.0
        np.fill_diagonal(adj, False)
        shape = classify_adjacency(adj)
        if shape in ("pair", "tree"):
            cls = "joint_forest"
        elif shape == "chordal":
            cls = "joint_chordal"
        else:
            cls = "joint_shared"
    bump(f"structure.classified.{cls}")
    return cls
