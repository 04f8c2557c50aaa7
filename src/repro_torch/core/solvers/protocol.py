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

``meta`` carries the rest: ``theta_warm`` (consumes a Theta0 seed beside
W0), ``fused_stack`` (the executor's wave packer may pack its small
buckets into one ``bucket_glasso`` launch a bin), ``force_fused`` (picking
the solver turns the packer on under ``EngineOptions(fused="auto")``) and
``max_fused_size`` (the largest bin it may pad into).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

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


def warm_start_solvers() -> frozenset[str]:
    """Names of the solvers that consume a W0 warm start (the
    ``WARM_START_SOLVERS`` view)."""
    return frozenset(n for n, s in _SPECS.items() if s.warm_startable)


def one_block(S, lam, W0=None, Theta0=None, device=None):
    """The single-block contract ``solve(S, lam, **opts)`` as a stack of
    one lane: (S[None], lams (1,), W0[None] or None, Theta0[None] or None),
    every operand a tensor on one device in S's dtype.  The device is
    ``device`` when given, else a tensor S's own, else ``"cuda"`` (an
    array S goes to the card unless the caller asks for the CPU)."""
    S = as_operand(S, device)
    lams = torch.as_tensor(lam, dtype=S.dtype, device=S.device).reshape(1)

    def lane(x):
        return None if x is None else torch.as_tensor(x, dtype=S.dtype, device=S.device)[None]

    return S[None], lams, lane(W0), lane(Theta0)


def as_operand(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; with ``device=None`` a tensor stays
    where it is and anything else goes to ``"cuda"``, the port's default
    (``engine.options.resolve_device``: raises without CUDA)."""
    from repro_torch.engine.options import resolve_device

    if device is None and isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device("cuda" if device is None else device))
