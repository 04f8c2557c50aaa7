"""Planning one lambda: partition -> classify -> bucket.

Each component of the screening partition is CLASSIFIED
(``engine.structure``) so buckets are homogeneous in (padded size, structure
class) and the executor can route a whole bucket down one rung of the solver
ladder.  The reference's path planning (one union-find pass for a whole
lambda grid, diffed plans, lifetime bucketing) comes with ``glasso_path``.

Counters (repro_torch.core.instrument):
    planner.plans_built          one per plan
    planner.buckets_padded       buckets padded and stacked
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import blocks as blocks_mod
from repro_torch.core.components import component_lists
from repro_torch.core.instrument import bump, set_peak
from repro_torch.engine.structure import classify_component


def build_plan_incremental(
    S: np.ndarray,
    lam: float,
    labels: np.ndarray,
    *,
    dtype=np.float64,
    classify_structures: bool = True,
) -> blocks_mod.Plan:
    """Group the components of ``labels`` into padded (size, structure)
    buckets.

    ``classify_structures=False`` tags every bucket "general": required when
    routing is off and when ``labels`` does not come from real screening
    (screen=False forces one global pseudo-component, which is not
    connected — the classifier's precondition)."""
    bump("planner.plans_built")
    comps = component_lists(labels)
    classify = (
        (lambda c: classify_component(S, c, lam)) if classify_structures else None
    )
    isolated, by_key = blocks_mod.group_components(comps, classify=classify)
    buckets = []
    for (size, structure), members in by_key.items():
        buckets.append(
            blocks_mod.make_bucket(S, size, members, dtype=dtype, structure=structure)
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
    return plan
