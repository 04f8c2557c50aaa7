"""Backend registries for the screening stage and the solver-routing ladder.

One contract for every implementation of the paper's eq.-(4) partition step:

    backend(S, lam, **opts) -> int labels, shape (p,), CANONICAL
    (labels[i] == smallest vertex index in i's component)

``"host"`` (numpy union-find) is the registered backend; the reference's
device backends come with the ``threshold_cc`` kernel.  Register more with
``@register_cc_backend("name")``.

The second registry is the ROUTING LADDER: structure class (assigned per
bucket by the planner via ``engine.structure``) -> executor route:

    "singleton" -> "assemble"     closed-form at scatter time, no dispatch
    "pair"      -> "closed_form"  batched forest kernel (tree_glasso)
    "tree"      -> "closed_form"  batched forest kernel (tree_glasso)
    "chordal"   -> "chordal"      host clique-tree direct solve
    "general"   -> "iterative"    the configured solver (bucket_glasso)

Every non-iterative route is KKT-verified by the executor and falls back to
"iterative" on failure, so re-routing a class (``set_route``) changes cost,
never correctness.  The solver protocol is re-exported here so every
extension point shares one import.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.instrument import bump
from repro_torch.core.solvers.protocol import (  # noqa: F401  (re-export surface)
    SolverSpec,
    available_solvers,
    register_solver,
    solver_spec,
)

CCBackend = Callable[..., np.ndarray]

_REGISTRY: dict[str, CCBackend] = {}


def register_cc_backend(name: str) -> Callable[[CCBackend], CCBackend]:
    """Decorator: register ``fn(S, lam, **opts) -> canonical labels``."""

    def deco(fn: CCBackend) -> CCBackend:
        _REGISTRY[name] = fn
        return fn

    return deco


def available_cc_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_cc_backend(name: str) -> CCBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cc backend {name!r}; available: {available_cc_backends()}"
        ) from None


def label_components(S, lam: float, *, backend: str = "host", **opts) -> np.ndarray:
    """Screen S at lam through the named backend; returns canonical labels."""
    fn = get_cc_backend(backend)
    bump(f"registry.cc.{backend}")
    labels = np.asarray(fn(S, lam, **opts))
    if labels.shape != (np.asarray(S).shape[0],):
        raise AssertionError(
            f"backend {backend!r} broke the contract: labels shape "
            f"{labels.shape} for p={np.asarray(S).shape[0]}"
        )
    return labels


#: executor routes, cheapest first; "iterative" is the ladder's tail and the
#: fallback target of every verified fast path
ROUTES = ("assemble", "closed_form", "chordal", "iterative")

_ROUTE_OF: dict[str, str] = {
    "singleton": "assemble",
    "pair": "closed_form",
    "tree": "closed_form",
    "chordal": "chordal",
    "general": "iterative",
}


def route_for(structure: str) -> str:
    """Executor route for a bucket's structure class (unknown classes take
    the iterative tail)."""
    return _ROUTE_OF.get(structure, "iterative")


def set_route(structure: str, route: str) -> None:
    """Re-route a structure class (e.g. force "tree" -> "iterative")."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; available: {ROUTES}")
    _ROUTE_OF[structure] = route


def solver_routes() -> dict[str, str]:
    return dict(_ROUTE_OF)


@register_cc_backend("host")
def _host(S, lam, **_opts) -> np.ndarray:
    from repro_torch.core.components import components_from_covariance_host

    return components_from_covariance_host(np.asarray(S), float(lam))
