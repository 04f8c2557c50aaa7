"""Joint-plan construction: K-stacked buckets over the union partition.

The single-class planner buckets same-(padded size, structure) components so
one batched solver call covers a whole bucket; the joint planner reuses that
machinery (``blocks.group_components`` with the union-graph classifier from
``repro_torch.joint.screen``) but every bucket carries a (n_blocks, K, size, size)
stack — the K class blocks of each component, gathered per class through the
covariance gather protocol, so dense stacks and per-class materialized
streamed covariances plan identically.

Padding is per class with the identity, and is exact for the joint problem
by the same Theorem-1 corollary as the single-class case: a padded
coordinate has zero off-diagonal entries in EVERY class, so no hybrid
condition can make it an edge (both (G) and (F) of ``screen.py`` hold
trivially at s = 0), and its joint solution is 1/(1 + lam1) on each class
diagonal — exactly what ``assemble_joint`` discards.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import blocks as blocks_mod
from repro_torch.core.components import component_lists
from repro_torch.core.instrument import bump, set_peak
from repro_torch.joint.screen import classify_joint_component


@dataclass
class JointBucket:
    size: int                      # padded per-class block size
    comps: list[np.ndarray]        # member-vertex arrays
    blocks: np.ndarray             # (n_blocks, K, size, size) padded stacks
    structure: str = "joint_general"


@dataclass
class JointPlan:
    p: int
    K: int
    lam1: float
    lam2: float
    penalty: str
    labels: np.ndarray
    isolated: np.ndarray           # vertex ids with |comp| = 1
    buckets: list[JointBucket] = field(default_factory=list)

    @property
    def n_components(self) -> int:
        return len(self.isolated) + sum(len(b.comps) for b in self.buckets)


def make_joint_bucket(
    Ss, size: int, members: list[np.ndarray], *, dtype=np.float64,
    structure: str = "joint_general",
) -> JointBucket:
    """Pad and stack one size-group of union components across all classes."""
    stacks = []
    for c in members:
        stacks.append(
            np.stack(
                [
                    blocks_mod.pad_block(
                        blocks_mod.gather_submatrix(S, c, dtype=dtype), size
                    )
                    for S in Ss
                ]
            )
        )
    return JointBucket(
        size=size, comps=members, blocks=np.stack(stacks), structure=structure
    )


def build_joint_plan(
    Ss,
    lam1: float,
    lam2: float,
    labels: np.ndarray,
    *,
    penalty: str,
    dtype=np.float64,
    classify_structures: bool = True,
) -> JointPlan:
    """Group union components into padded same-(size, K, structure) buckets.

    ``classify_structures=False`` tags every bucket "joint_general" — the
    unrouted baseline (every block takes the joint ADMM), required when
    ``labels`` does not come from a real hybrid screen (screen=False forces
    one global pseudo-component, which is not a union component)."""
    bump("planner.plans_built")
    comps = component_lists(labels)
    classify = (
        (lambda c: classify_joint_component(Ss, c, lam1, lam2, penalty=penalty))
        if classify_structures
        else None
    )
    isolated, by_key = blocks_mod.group_components(comps, classify=classify)
    buckets = []
    for (size, structure), members in by_key.items():
        bump("planner.buckets_padded")
        buckets.append(
            make_joint_bucket(
                Ss, size, members, dtype=dtype,
                structure=structure if classify is not None else "joint_general",
            )
        )
    p = Ss[0].shape[0]
    return JointPlan(
        p=p,
        K=len(Ss),
        lam1=float(lam1),
        lam2=float(lam2),
        penalty=penalty,
        labels=np.asarray(labels),
        isolated=isolated,
        buckets=buckets,
    )


def assemble_joint(
    plan: JointPlan, bucket_solutions: list[np.ndarray], Ss
) -> np.ndarray:
    """Scatter per-component joint solutions into the dense (K, p, p) Theta.

    Delegates per class to the single-class ``assemble_dense`` (batched
    fancy-index scatter, isolated vertices closed-form at 1/(S_ii + lam1) —
    lam2 never touches the diagonal, so the single-class formula IS the
    joint one), writing per-class views of ONE (K, p, p) allocation — the
    dense stack is touched exactly once."""
    dtype = (
        np.asarray(bucket_solutions[0]).dtype
        if bucket_solutions
        else blocks_mod.cov_dtype(Ss[0])
    )
    out = np.zeros((plan.K, plan.p, plan.p), dtype=dtype)
    set_peak("result.bytes_peak", out.nbytes)
    shim = blocks_mod.Plan(
        p=plan.p,
        lam=plan.lam1,
        labels=plan.labels,
        isolated=plan.isolated,
        buckets=[
            blocks_mod.Bucket(
                size=b.size, comps=b.comps, blocks=None, structure=b.structure
            )
            for b in plan.buckets
        ],
    )
    for k in range(plan.K):
        sols_k = [np.asarray(sols)[:, k] for sols in bucket_solutions]
        blocks_mod.assemble_dense(shim, sols_k, Ss[k], out=out[k])
    return out


def assemble_joint_sparse(
    plan: JointPlan, bucket_solutions: list[np.ndarray], Ss
):
    """Assemble per-component joint solutions into a ``JointSparseTheta``
    with no (K, p, p) allocation — the joint sibling of ``core.blocks.
    assemble_sparse``: the (n, K, size, size) bucket stacks become the block
    storage as they are, one shared component index serves every class, and
    isolated vertices keep their per-class closed form 1/(S_ii + lam1)."""
    from repro_torch.core.sparse import JointSparseTheta, _build_index

    stacks = [np.asarray(sols) for sols in bucket_solutions]
    dtype = stacks[0].dtype if stacks else blocks_mod.cov_dtype(Ss[0])
    comps: list[np.ndarray] = []
    loc: list[tuple[int, int]] = []
    for s, bucket in enumerate(plan.buckets):
        for r, comp in enumerate(bucket.comps):
            comps.append(np.asarray(comp, dtype=np.int64))
            loc.append((s, r))
    isolated = np.asarray(plan.isolated, dtype=np.int64)
    if isolated.size:
        iso_vals = np.stack(
            [
                (1.0 / (blocks_mod.gather_diag(S, isolated) + plan.lam1)).astype(
                    dtype, copy=False
                )
                for S in Ss
            ]
        )
    else:
        iso_vals = np.zeros((plan.K, 0), dtype=dtype)
    comp_id, pos_in = _build_index(plan.p, comps, isolated)
    Theta = JointSparseTheta(
        plan.K, plan.p, dtype, stacks, comps, loc, comp_id, pos_in,
        isolated, iso_vals,
    )
    set_peak("result.bytes_peak", Theta.nbytes())
    return Theta
