"""Scheduling components across workers (devices of a mesh).

The paper's footnote 4: "Distributing these operations depend upon the number
of processors available, their capacities ... it is often desirable to club
smaller components into a single machine."  Made concrete, as in the
reference's ``repro.core.schedule``:

  * cost model: solving a size-b block costs ~ b^3 (Section 3: O(p^J), J=3),
  * LPT (longest-processing-time) greedy bin packing — 4/3-approximate
    makespan, ideal for the heavy-tailed component-size distributions Figure 1
    shows (the executor places its buckets on ``BucketExecutor.devices``
    this way),
  * capacity check against a per-worker p_max (consequence 5 of Theorem 1):
    if any component exceeds p_max the scheduler reports the smallest feasible
    lambda instead of an assignment,
  * elastic rebalance = re-run on the surviving worker set; assignments are
    pure functions of (sizes, n_workers) so recovery is deterministic.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


def default_cost(b: int) -> float:
    return float(b) ** 3


@dataclass
class Assignment:
    worker_of: np.ndarray          # component index -> worker id
    loads: np.ndarray              # per-worker total cost
    makespan: float
    balance: float                 # makespan / mean load (1.0 = perfect)


def lpt_assign(
    sizes, n_workers: int, *, cost=default_cost, priorities=None
) -> Assignment:
    """LPT greedy assignment; ``priorities`` (higher = more urgent, same
    length as ``sizes``) makes the placement priority-aware: urgent items
    are placed FIRST — they land on the least-loaded workers and sit at the
    front of each worker's dispatch order — with LPT's cost-descending
    order intact within a priority level, so the makespan bound is
    unchanged for uniform priorities."""
    sizes = np.asarray(sizes)
    if priorities is None:
        order = np.argsort(-sizes, kind="stable")
    else:
        priorities = np.asarray(priorities, dtype=float)
        if priorities.shape != sizes.shape:
            raise ValueError(
                f"priorities shape {priorities.shape} != sizes {sizes.shape}"
            )
        # lexsort: last key is primary — priority desc, then cost desc
        order = np.lexsort((-sizes.astype(float), -priorities))
    loads = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(loads)
    worker_of = np.zeros(sizes.size, dtype=np.int64)
    for idx in order:
        load, w = heapq.heappop(loads)
        worker_of[idx] = w
        heapq.heappush(loads, (load + cost(int(sizes[idx])), w))
    per = np.zeros(n_workers)
    for idx, w in enumerate(worker_of):
        per[w] += cost(int(sizes[idx]))
    makespan = float(per.max()) if n_workers else 0.0
    mean = float(per.mean()) if n_workers else 0.0
    return Assignment(
        worker_of=worker_of,
        loads=per,
        makespan=makespan,
        balance=makespan / mean if mean > 0 else 1.0,
    )


def feasible_lambda(S: np.ndarray, p_max: int) -> float:
    """Smallest lambda at which every component fits a p_max-capacity
    worker (consequence 5)."""
    from repro_torch.core.partition import lambda_for_max_component

    return lambda_for_max_component(S, p_max)


def check_capacity(sizes, p_max: int | None) -> None:
    if p_max is None:
        return
    sizes = np.asarray(sizes)
    if sizes.size and sizes.max() > p_max:
        raise ValueError(
            f"component of size {int(sizes.max())} exceeds worker capacity "
            f"p_max={p_max}; increase lambda (see schedule.feasible_lambda)"
        )
