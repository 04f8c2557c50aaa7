"""The Solver protocol: capability-tagged specs behind one registry.

A ``SolverSpec`` states a solver's contract once, and the executor consults
the spec instead of hard-coded name sets:

    fn              batched solve over a padded bucket stack:
                    fn(blocks (N, b, b), lams (N,), *, W0=None, Theta0=None,
                    **opts) -> Theta (N, b, b) — the port writes the batch
                    dimension out where the reference vmaps a per-block fn
    batched         the executor may hand it a bucket stack
    warm_startable  genuinely consumes a W0 covariance warm start
    sharded         runs one oversize block on the row-sharded layout
                    (``glasso_sharded``'s signature and ``ShardedSolve``
                    result); dispatched per block down the executor's
                    "sharded" route, never batched
    iterative       eligible as the routing ladder's tail
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

_SPECS: dict[str, "SolverSpec"] = {}


@dataclass(frozen=True)
class SolverSpec:
    """One solver's contract; see the module docstring for the fields."""

    name: str
    fn: Callable
    batched: bool = True
    warm_startable: bool = False
    sharded: bool = False
    iterative: bool = True
    description: str = ""
    meta: dict = field(default_factory=dict)


def register_solver(spec: SolverSpec) -> SolverSpec:
    """Register (or replace) a solver spec; returns it for chaining."""
    if spec.sharded and spec.batched:
        raise ValueError(
            f"solver {spec.name!r}: sharded solvers span the mesh and cannot "
            "also be vmapped over a bucket stack (batched=True)"
        )
    _SPECS[spec.name] = spec
    return spec


def solver_spec(name: str) -> SolverSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {available_solvers()}"
        ) from None


def available_solvers(**caps: bool) -> tuple[str, ...]:
    """Registered solver names, optionally filtered by capability flags."""
    names = []
    for name, spec in sorted(_SPECS.items()):
        if all(getattr(spec, cap) == want for cap, want in caps.items()):
            names.append(name)
    return tuple(names)


def block_solvers() -> dict[str, Callable]:
    """name -> fn for the user-pickable block solvers (the ``SOLVERS``
    view: batched, iterative, not sharded)."""
    return {
        name: spec.fn
        for name, spec in sorted(_SPECS.items())
        if spec.batched and spec.iterative and not spec.sharded
    }
