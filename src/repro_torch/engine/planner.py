"""Planning one lambda: partition -> classify -> bucket.

Each component of the screening partition is CLASSIFIED
(``engine.structure``) so buckets are homogeneous in (padded size, structure
class) and the executor can route a whole bucket down one rung of the solver
ladder.  The reference's path planning (one union-find pass for a whole
lambda grid, diffed plans, lifetime bucketing) comes with ``glasso_path``.

Counters (repro_torch.core.instrument):
    planner.plans_built              one per plan
    planner.buckets_padded           buckets padded and stacked
    structure.classified.oversize    components classed "oversize"
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import blocks as blocks_mod
from repro_torch.core.components import component_lists
from repro_torch.core.instrument import bump, set_peak
from repro_torch.engine.structure import classify_component


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


def build_plan_incremental(
    S: np.ndarray,
    lam: float,
    labels: np.ndarray,
    *,
    dtype=np.float64,
    classify_structures: bool = True,
    oversize: int | None = None,
) -> blocks_mod.Plan:
    """Group the components of ``labels`` into padded (size, structure)
    buckets.

    ``classify_structures=False`` tags every bucket "general": required when
    routing is off and when ``labels`` does not come from real screening
    (screen=False forces one global pseudo-component, which is not
    connected — the classifier's precondition).

    ``oversize`` is the single-device block-size cap (``blocks.
    oversize_threshold``): larger components are classed "oversize" and
    carry no host block stack — the executor's sharded route gathers them
    straight onto the device."""
    bump("planner.plans_built")
    comps = component_lists(labels)
    classify = _classifier(S, lam, oversize) if classify_structures else None
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
