"""Worker capacity (consequence 5 of Theorem 1).

The port runs one card per solve, so the reference's LPT placement across
devices has no counterpart yet; the capacity check and the feasible lambda
it points to are what the single-solve path uses."""

from __future__ import annotations

import numpy as np


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
