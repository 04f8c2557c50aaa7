"""Component extraction, size-bucketing/padding, and solution scatter-back.

Components arrive in many ragged sizes; each is padded to a bucket size
(powers of two by default) and same-bucket blocks are stacked so one batched
solver launch handles the whole bucket.

Padding correctness is itself a corollary of Theorem 1: the padded input
S_pad = blkdiag(S_comp, I_pad) has zero off-block entries <= lam, so its
glasso solution is exactly blkdiag(Theta_comp, (1/(1+lam)) I_pad) — the
padded coordinates never contaminate the component's solution.

Isolated nodes (|comp| = 1) are closed-form: Theta_ii = 1/(S_ii + lam).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.instrument import set_peak


def bucket_size(b: int, *, min_bucket: int = 2) -> int:
    """Next power of two >= b (>= min_bucket)."""
    size = min_bucket
    while size < b:
        size *= 2
    return size


def plan_bucket_size(b: int, *, single_block: bool = False, min_bucket: int = 2) -> int:
    """Padded size for a component of size b inside a plan.

    Buckets holding several blocks stay at the next power of two.  A bucket
    holding a SINGLE block gets next-multiple-of-128 padding above 256
    instead (1025 -> 1152 rather than 2048, at b^3 cost)."""
    p2 = bucket_size(b, min_bucket=min_bucket)
    if not single_block or b <= 128:
        return p2
    return min(p2, ((b + 127) // 128) * 128)


#: working-set multiplier for a SINGLE-DEVICE iterative solve of one (b, b)
#: block: S, the solver pair (Z/U or Theta/W), the eigh/Cholesky workspace
#: and the result — the memory model behind the oversize threshold
SINGLE_DEVICE_BUFFERS = 8


def oversize_threshold(budget_mb: float, dtype=np.float64) -> int:
    """Largest block size a single device's memory budget can solve.

    Components LARGER than this are classed "oversize" by the planner and
    routed to the sharded solver.  The model is ``SINGLE_DEVICE_BUFFERS``
    resident (b, b) buffers:

        b_max = sqrt(budget_bytes / (SINGLE_DEVICE_BUFFERS * itemsize))
    """
    budget_bytes = float(budget_mb) * 2**20
    itemsize = np.dtype(dtype).itemsize
    return max(1, int(np.sqrt(budget_bytes / (SINGLE_DEVICE_BUFFERS * itemsize))))


def group_components(
    comps: list[np.ndarray], classify=None
) -> tuple[np.ndarray, dict[tuple[int, str], list[np.ndarray]]]:
    """Split components into (isolated vertices, {(padded size, structure):
    members}).

    ``classify`` maps a component's vertex array to its structure class
    (``repro_torch.engine.structure``); None tags everything "general".
    Grouping is by power-of-two size; groups that end up with exactly one
    block are then re-padded to their mild single-block size."""
    isolated = np.array(
        sorted(int(c[0]) for c in comps if len(c) == 1), dtype=np.int64
    )
    by_p2: dict[tuple[int, str], list[np.ndarray]] = {}
    for c in comps:
        if len(c) == 1:
            continue
        structure = classify(c) if classify is not None else "general"
        by_p2.setdefault((bucket_size(len(c)), structure), []).append(c)
    by_key: dict[tuple[int, str], list[np.ndarray]] = {}
    for (_, structure), members in by_p2.items():
        size = plan_bucket_size(len(members[0]), single_block=len(members) == 1)
        by_key.setdefault((size, structure), []).extend(members)
    return isolated, dict(sorted(by_key.items()))


def pad_block(S_block: np.ndarray, size: int) -> np.ndarray:
    b = S_block.shape[0]
    out = np.eye(size, dtype=S_block.dtype)
    out[:b, :b] = S_block
    return out


def gather_submatrix(S, idx: np.ndarray, *, dtype=None) -> np.ndarray:
    """S[np.ix_(idx, idx)] through the covariance gather protocol, cast to
    ``dtype`` when given.

    Dense arrays index directly; objects exposing ``gather_block`` (the
    streaming screener's ``MaterializedCovariance``) serve the same entries
    from per-component blocks — the planner, executor and classifier never
    learn which input produced S."""
    if hasattr(S, "gather_block"):
        blk = S.gather_block(idx)
    else:
        blk = np.asarray(S)[np.ix_(idx, idx)]
    return blk if dtype is None else blk.astype(dtype, copy=False)


def gather_diag(S, idx) -> np.ndarray:
    """S[idx, idx] (diagonal gather) through the same protocol."""
    if hasattr(S, "diag_at"):
        return S.diag_at(idx)
    return np.asarray(S)[idx, idx]


def gather_submatrix_rows(S, rows: np.ndarray, cols: np.ndarray, *, dtype=None) -> np.ndarray:
    """S[np.ix_(rows, cols)] through the gather protocol (both index sets
    inside ONE component): the rectangular sibling of
    ``gather_submatrix``."""
    if hasattr(S, "gather_block_rows"):
        blk = S.gather_block_rows(rows, cols)
    else:
        blk = np.asarray(S)[np.ix_(rows, cols)]
    return blk if dtype is None else blk.astype(dtype, copy=False)


def cov_dtype(S) -> np.dtype:
    """The numpy dtype of a covariance operand — dense array or gather-
    protocol object (``MaterializedCovariance`` carries ``.dtype``)."""
    if hasattr(S, "gather_block"):
        return np.dtype(S.dtype)
    return np.asarray(S).dtype


@dataclass
class Bucket:
    size: int                                  # padded block size
    comps: list[np.ndarray]                    # member-vertex arrays
    blocks: np.ndarray | None                  # (n_blocks, size, size) padded S;
                                               # None for "oversize" buckets —
                                               # the sharded route gathers
                                               # straight into device shards
    structure: str = "general"                 # routing ladder class


@dataclass
class Plan:
    p: int
    lam: float
    labels: np.ndarray
    isolated: np.ndarray                       # vertex ids with |comp| = 1
    buckets: list[Bucket] = field(default_factory=list)

    @property
    def n_components(self) -> int:
        return len(self.isolated) + sum(len(b.comps) for b in self.buckets)

    @property
    def max_comp(self) -> int:
        mx = 1 if len(self.isolated) else 0
        for b in self.buckets:
            mx = max(mx, max(len(c) for c in b.comps))
        return mx

    def block_bytes(self) -> int:
        """Bytes held by the plan's padded input stacks (oversize buckets
        carry none)."""
        return int(
            sum(b.blocks.nbytes for b in self.buckets if b.blocks is not None)
        )


def make_bucket(
    S: np.ndarray,
    size: int,
    members: list[np.ndarray],
    *,
    dtype=np.float64,
    structure: str = "general",
) -> Bucket:
    """Pad and stack one size-group of components (the only place padded
    bucket stacks are built, so the padding convention cannot drift).

    "oversize" buckets carry NO host block stack: the executor's sharded
    route gathers each block row chunk by row chunk straight onto the
    device (``stream.materialize.shard_gather``)."""
    if structure == "oversize":
        return Bucket(size=size, comps=members, blocks=None, structure=structure)
    blocks = np.stack(
        [pad_block(gather_submatrix(S, c, dtype=dtype), size) for c in members]
    )
    return Bucket(size=size, comps=members, blocks=blocks, structure=structure)


def build_plan(
    S: np.ndarray, lam: float, labels: np.ndarray, *, dtype=np.float64, classify=None
) -> Plan:
    """Group components into padded same-(size, structure) buckets.

    ``classify`` tags each component with its routing-ladder structure class
    (see ``group_components``); None keeps every bucket "general".  The
    engine plans through ``engine.planner.build_plan_incremental``, which
    gives the same buckets."""
    from repro_torch.core.components import component_lists

    comps = component_lists(labels)
    isolated, by_key = group_components(comps, classify=classify)
    buckets = [
        make_bucket(S, size, members, dtype=dtype, structure=structure)
        for (size, structure), members in by_key.items()
    ]
    return Plan(p=S.shape[0], lam=float(lam), labels=labels, isolated=isolated, buckets=buckets)


def solve_bucket(blocks, lam: float, solver, *, W0=None, device=None, **solver_opts):
    """Solve one bucket's stacked padded blocks at one lam: a single
    batched call of ``solver``, a registered name or a batched fn
    ``fn(blocks (N, b, b), lams (N,), *, W0=None, **opts) -> Theta`` (the
    ``core.solvers.SOLVERS`` contract; the reference vmaps a per-block
    solver instead).  ``blocks`` is a tensor (solved where it lies unless
    ``device`` is given) or an array (solved on ``device``, ``"cuda"`` by
    default); ``W0``, if given, is a per-block stack of warm-start
    covariance iterates."""
    import torch

    from repro_torch.core.solvers import solver_spec
    from repro_torch.core.solvers.protocol import as_operand

    fn = solver_spec(solver).fn if isinstance(solver, str) else solver
    blocks = as_operand(blocks, device)
    lams = torch.full((blocks.shape[0],), float(lam), dtype=blocks.dtype, device=blocks.device)
    if W0 is not None:
        W0 = torch.as_tensor(W0, dtype=blocks.dtype, device=blocks.device)
    return fn(blocks, lams, W0=W0, **solver_opts)


def assemble_dense(
    plan: Plan, bucket_solutions: list[np.ndarray], S: np.ndarray, *,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Scatter per-component solutions back into the global dense Theta.

    Members of one bucket that share a size scatter with a single fancy-index
    assignment.  ``out``, when given, is a zero-initialized (p, p) buffer to
    assemble into (the joint assembler passes per-class views of one
    (K, p, p) allocation)."""
    p = plan.p
    if out is not None:
        Theta = out
    else:
        dtype = (
            np.asarray(bucket_solutions[0]).dtype
            if bucket_solutions
            else cov_dtype(S)
        )
        Theta = np.zeros((p, p), dtype=dtype)
        set_peak("result.bytes_peak", Theta.nbytes)
    if len(plan.isolated):
        Theta[plan.isolated, plan.isolated] = 1.0 / (
            gather_diag(S, plan.isolated) + plan.lam
        )
    for bucket, sols in zip(plan.buckets, bucket_solutions):
        sols = np.asarray(sols)
        by_b: dict[int, list[int]] = {}
        for i, comp in enumerate(bucket.comps):
            by_b.setdefault(len(comp), []).append(i)
        for b, idxs in by_b.items():
            if len(idxs) == 1:
                comp = bucket.comps[idxs[0]]
                Theta[np.ix_(comp, comp)] = sols[idxs[0]][:b, :b]
            else:
                rows = np.stack([bucket.comps[i] for i in idxs])   # (n, b)
                Theta[rows[:, :, None], rows[:, None, :]] = sols[idxs][:, :b, :b]
    return Theta


def assemble_sparse(plan: Plan, bucket_solutions: list[np.ndarray], S):
    """Assemble per-bucket solutions into a ``SparseTheta`` with no (p, p)
    allocation: the bucket solution stacks become the result's block
    storage as they are (no copy), and only the (p,) index maps and the
    isolated closed-form diagonal are built on top.

    The dense and sparse assemblers consume identical inputs, so
    ``assemble_dense`` of the same ``bucket_solutions`` densifies to the
    bitwise identical matrix."""
    from repro_torch.core.sparse import SparseTheta, _build_index

    stacks = [np.asarray(sols) for sols in bucket_solutions]
    dtype = stacks[0].dtype if stacks else cov_dtype(S)
    comps: list[np.ndarray] = []
    loc: list[tuple[int, int]] = []
    for s, bucket in enumerate(plan.buckets):
        for r, comp in enumerate(bucket.comps):
            comps.append(np.asarray(comp, dtype=np.int64))
            loc.append((s, r))
    isolated = np.asarray(plan.isolated, dtype=np.int64)
    if isolated.size:
        iso_vals = (
            1.0 / (gather_diag(S, isolated) + plan.lam)
        ).astype(dtype, copy=False)
    else:
        iso_vals = np.zeros(0, dtype=dtype)
    comp_id, pos_in = _build_index(plan.p, comps, isolated)
    Theta = SparseTheta(
        plan.p, dtype, stacks, comps, loc, comp_id, pos_in, isolated, iso_vals
    )
    set_peak("result.bytes_peak", Theta.nbytes())
    return Theta
