"""Planning: screen -> partition -> classify -> bucket, one lambda or a
whole descending path with diffed plans.

Each component of the screening partition is CLASSIFIED
(``engine.structure``) so buckets are homogeneous in (padded size, structure
class) and the executor can route a whole bucket down one rung of the solver
ladder.

A descending lambda grid needs exactly ONE union-find pass over the
edge-sorted |S_ij| (Theorem 2: components only merge), after which each
lambda's plan is a snapshot (``plan_path``).  Consecutive plans are DIFFED at
bucket granularity: a bucket whose (padded size, structure, members) key is
unchanged keeps its padded block stack and is marked reusable, so the
executor also keeps its device stack and recycles its previous solution as
a warm start.  Because the whole grid is planned up front, each component's
LIFETIME (first and last step it exists) is known, and buckets are split by
it: all members of a bucket appear and merge together, so a bucket is reused
at every step it survives.

Counters (repro_torch.core.instrument):
    partition.unionfind_passes       exactly 1 per ``plan_path`` call
    planner.plans_built              one per plan
    planner.buckets_padded           buckets padded and stacked
    planner.buckets_reused           buckets carried over from the previous lambda
    structure.classified.oversize    components classed "oversize"
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import blocks as blocks_mod
from repro_torch.core.components import component_lists
from repro_torch.core.instrument import bump, set_peak
from repro_torch.core.partition import _sorted_edges, labels_at_thresholds
from repro_torch.core.screening import ScreenStats
from repro_torch.engine.structure import classify_component


def bucket_key(bucket: blocks_mod.Bucket) -> tuple:
    """Identity of a bucket across lambdas: padded size + structure class +
    exact membership.  S is fixed along a path, so equal membership implies
    bit-identical padded blocks; the structure class is lambda-dependent
    (edges appear as lambda drops even when membership is unchanged), so a
    bucket that changed class is re-made rather than re-routed."""
    return (
        bucket.size,
        bucket.structure,
        tuple(np.asarray(c).tobytes() for c in bucket.comps),
    )


def _screen_stats(labels: np.ndarray, lam: float, sorted_w: np.ndarray, seconds: float) -> ScreenStats:
    _, counts = np.unique(labels, return_counts=True)
    # sorted_w is descending; edges are strict |S_ij| > lam (eq. (4))
    n_edges = int(np.searchsorted(-sorted_w, -lam, side="left"))
    return ScreenStats(
        lam=float(lam),
        n_components=int(counts.size),
        max_comp=int(counts.max()),
        n_isolated=int((counts == 1).sum()),
        n_edges=n_edges,
        seconds=seconds,
    )


@dataclass
class PathStep:
    """One lambda's executable plan plus its diff against the previous step."""

    lam: float
    labels: np.ndarray
    plan: blocks_mod.Plan
    screen: ScreenStats
    reused_keys: frozenset = frozenset()  # bucket_key()s carried over

    def is_reused(self, bucket: blocks_mod.Bucket) -> bool:
        return bucket_key(bucket) in self.reused_keys


@dataclass
class PathPlan:
    p: int
    lambdas: list[float] = field(default_factory=list)  # descending
    steps: list[PathStep] = field(default_factory=list)


def _classifier(S, lam: float, oversize: int | None):
    """Structure classifier with the oversize short-circuit.

    The size check runs BEFORE graph classification: an oversize component
    is sharded regardless of its subgraph shape, and running MCS/PEO on a
    near-p component would cost more than any route it could unlock."""
    def classify(c):
        if oversize is not None and len(c) > oversize:
            bump("structure.classified.oversize")
            return "oversize"
        return classify_component(S, c, lam)

    return classify


def component_lifetimes(labels_list) -> dict:
    """Map component membership (``tobytes`` of its sorted vertex array) to
    its (birth step, death step) over a descending-lambda sequence of label
    snapshots.  Nested partitions (Theorem 2) make each lifetime one run of
    consecutive steps, so recording the first and last sighting is exact."""
    life: dict = {}
    for t, labels in enumerate(labels_list):
        for c in component_lists(labels):
            b = c.tobytes()
            life[b] = (life[b][0], t) if b in life else (t, t)
    return life


def build_plan_incremental(
    S: np.ndarray,
    lam: float,
    labels: np.ndarray,
    *,
    prev: blocks_mod.Plan | None = None,
    dtype=np.float64,
    classify_structures: bool = True,
    oversize: int | None = None,
    lifetime_of: dict | None = None,
) -> tuple[blocks_mod.Plan, frozenset]:
    """Group the components of ``labels`` into padded (size, structure)
    buckets, reusing the buckets of ``prev`` whose key is unchanged.

    ``lifetime_of`` (``component_lifetimes`` of the whole grid) splits each
    (size, structure) group by member (birth, death): bucket membership is
    then static for the bucket's whole life and reuse holds at every step
    of it.  The path planners pass it; single solves do not and get the
    plain grouping.

    ``classify_structures=False`` tags every bucket "general": required when
    routing is off and when ``labels`` does not come from real screening
    (screen=False forces one global pseudo-component, which is not
    connected — the classifier's precondition).

    ``oversize`` is the single-device block-size cap (``blocks.
    oversize_threshold``): larger components are classed "oversize" and
    carry no host block stack — the executor's sharded route gathers them
    straight onto the device.

    Returns (plan, reused bucket keys)."""
    bump("planner.plans_built")
    comps = component_lists(labels)
    classify = _classifier(S, lam, oversize) if classify_structures else None
    isolated, by_key = blocks_mod.group_components(comps, classify=classify)
    prev_by_key = {bucket_key(b): b for b in prev.buckets} if prev is not None else {}
    buckets, reused = [], set()
    for (size, structure), members in by_key.items():
        if lifetime_of is None:
            groups = [members]
        else:
            by_life: dict = {}
            for c in members:
                by_life.setdefault(lifetime_of[np.asarray(c).tobytes()], []).append(c)
            # order members by first vertex: canonical labels are renumbered
            # after every merge, so label order would shuffle a surviving
            # bucket's membership tuple and break its reuse key
            groups = [
                sorted(by_life[d], key=lambda c: int(np.asarray(c)[0]))
                for d in sorted(by_life)
            ]
        for mem in groups:
            key = (size, structure, tuple(np.asarray(c).tobytes() for c in mem))
            hit = prev_by_key.get(key)
            if hit is not None:
                buckets.append(hit)
                reused.add(key)
                bump("planner.buckets_reused")
            else:
                buckets.append(
                    blocks_mod.make_bucket(S, size, mem, dtype=dtype, structure=structure)
                )
                bump("planner.buckets_padded")
    plan = blocks_mod.Plan(
        p=S.shape[0],
        lam=float(lam),
        labels=labels,
        isolated=isolated,
        buckets=buckets,
    )
    set_peak("plan.bytes_peak", plan.block_bytes())
    return plan, frozenset(reused)


def plan_path(
    S: np.ndarray,
    lambdas,
    *,
    dtype=np.float64,
    classify_structures: bool = True,
    oversize: int | None = None,
) -> PathPlan:
    """Plan a whole descending-lambda path with one partition pass.

    Every lambda gets a PathStep whose ScreenStats come from the snapshot
    (no per-lambda thresholding or union-find).  The grid goes through the
    shared chokepoint ``select.grid.normalize_lambda_grid``: sorted
    descending, deduped, non-positive values rejected."""
    from repro_torch.select.grid import normalize_lambda_grid

    S = np.asarray(S)
    lams = normalize_lambda_grid(lambdas)
    t0 = time.perf_counter()
    # shared by the snapshot pass and edge counting; the grid's smallest
    # lambda bounds every insertion, so sub-threshold edges never sort
    edges = _sorted_edges(S, lam_min=lams[-1])
    labels_list = labels_at_thresholds(S, lams, edges=edges)
    sorted_w = edges[2]
    snap_seconds = (time.perf_counter() - t0) / max(len(lams), 1)

    life = component_lifetimes(labels_list)
    path = PathPlan(p=S.shape[0], lambdas=lams)
    prev_plan = None
    for lam, labels in zip(lams, labels_list):
        t1 = time.perf_counter()
        plan, reused = build_plan_incremental(
            S, lam, labels, prev=prev_plan, dtype=dtype,
            classify_structures=classify_structures, oversize=oversize,
            lifetime_of=life,
        )
        stats = _screen_stats(labels, lam, sorted_w, snap_seconds + (time.perf_counter() - t1))
        path.steps.append(
            PathStep(lam=lam, labels=labels, plan=plan, screen=stats, reused_keys=reused)
        )
        prev_plan = plan
    return path
