"""Backend registries for the screening stage and the solver-routing ladder.

One contract for every implementation of the paper's eq.-(4) partition step:

    backend(S, lam, **opts) -> int labels, shape (p,), CANONICAL
    (labels[i] == smallest vertex index in i's component)
    or (labels, n_edges) from a backend that counts the edges itself

Four backends ship, under the reference's names so ``cc_backend`` values
carried by ``EngineOptions.from_reference`` resolve:

    "host"       numpy union-find (the paper's ``graphconncomp`` role)
    "jax"        plain-torch min-label propagation + pointer jumping on the
                 engine's device (``core.components.connected_components_labelprop``)
    "pallas"     the ``threshold_cc`` CUDA hook step driven to a fixed point
                 (``kernels.threshold_cc``); its plain version on the CPU
    "shard_map"  the row-sharded screen across a mesh of devices
                 (``core.distributed.distributed_components``): S's rows
                 split over the mesh, one ``threshold_cc`` row-slab launch
                 a shard a round, the labels all-gathered between rounds

The device backends take ``device=`` (the engine passes its own;
``"cuda"`` by default, which raises without CUDA), copy S there once,
threshold it in its own dtype and count its edges on that copy, so the
screen's stats never read S on the host; ``"shard_map"`` also takes
``mesh=`` (the engine passes its own, ``Engine(devices=...)``; by default
``local_device_mesh(device)``) and counts the edges on its row shards.
Register more with ``@register_cc_backend("name")``.

The second registry is the ROUTING LADDER: structure class (assigned per
bucket by the planner via ``engine.structure``) -> executor route:

    "singleton" -> "assemble"     closed-form at scatter time, no dispatch
    "pair"      -> "closed_form"  batched forest kernel (tree_glasso)
    "tree"      -> "closed_form"  batched forest kernel (tree_glasso)
    "chordal"   -> "chordal"      host clique-tree direct solve
    "general"   -> "iterative"    the configured solver (bucket_glasso for
                                  bcd, prox_l1 for pg, shard_prox for admm)
    "oversize"  -> "sharded"      the matmul-only ADMM for blocks past the
                                  single-device cap (``oversize_threshold``),
                                  KKT-verified in place

"fused" is the iterative route's wave-packed variant (``set_route(
"general", "fused")``; ``EngineOptions(fused=True)`` packs every
iterative bucket the same way).

and the joint (K-class) union-graph classes of ``repro_torch.joint``:
"joint_forest" -> "closed_form", "joint_chordal" -> "chordal",
"joint_shared" -> "iterative" (one single-class bcd solve) and
"joint_general" -> "iterative" (the joint ADMM).

Every non-iterative route is KKT-verified by the executor and falls back to
"iterative" on failure (an oversize miss also bumps
``solver.oversize.fallbacks``), so re-routing a class (``set_route``) changes cost,
never correctness.  The solver protocol is re-exported here so every
extension point shares one import.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.instrument import bump
from repro_torch.core.solvers.protocol import (  # noqa: F401  (re-export surface)
    SolverSpec,
    available_solvers,
    register_solver,
    solver_spec,
)
from repro_torch.engine.options import resolve_device

CCBackend = Callable[..., np.ndarray]

_REGISTRY: dict[str, CCBackend] = {}


def register_cc_backend(name: str) -> Callable[[CCBackend], CCBackend]:
    """Decorator: register ``fn(S, lam, **opts) -> canonical labels`` (or
    ``(labels, n_edges)``)."""

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


def screen_components(
    S, lam: float, *, backend: str = "host", **opts
) -> tuple[np.ndarray, int | None]:
    """Screen S at lam through the named backend; returns (canonical
    labels, the strict upper-triangle edge count where the backend took it,
    else None)."""
    fn = get_cc_backend(backend)
    bump(f"registry.cc.{backend}")
    out = fn(S, lam, **opts)
    labels, n_edges = out if isinstance(out, tuple) else (out, None)
    labels = np.asarray(labels)
    p = S.shape[0]
    if labels.shape != (p,):
        raise AssertionError(
            f"backend {backend!r} broke the contract: labels shape "
            f"{labels.shape} for p={p}"
        )
    return labels, n_edges


def label_components(S, lam: float, *, backend: str = "host", **opts) -> np.ndarray:
    """Screen S at lam through the named backend; returns canonical labels."""
    return screen_components(S, lam, backend=backend, **opts)[0]


#: executor routes, cheapest first; "iterative" is the ladder's tail and the
#: fallback target of every verified fast path.  "fused" is the iterative
#: tail's megabatched variant: small buckets are re-packed across bucket
#: boundaries into size-binned stacks and solved with one
#: ``bucket_glasso`` launch a bin (``engine.waves``); buckets too large for
#: a bin, or a solver without the ``fused_stack`` capability, take plain
#: "iterative" — re-routing changes cost, never the answer
ROUTES = ("assemble", "closed_form", "chordal", "iterative", "fused", "sharded")

_ROUTE_OF: dict[str, str] = {
    "singleton": "assemble",
    "pair": "closed_form",
    "tree": "closed_form",
    "chordal": "chordal",
    "general": "iterative",
    "oversize": "sharded",
    # joint (K-class) union-graph classes: identical class blocks reduce to
    # ONE single-class problem at an effective lambda (repro_torch.joint);
    # class-specific blocks take the coupled joint ADMM through "iterative"
    "joint_forest": "closed_form",
    "joint_chordal": "chordal",
    "joint_shared": "iterative",
    "joint_general": "iterative",
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


def to_device(S, device) -> torch.Tensor:
    """S as a tensor on ``device`` in its own dtype (no cast); a tensor
    already there passes through."""
    dev = resolve_device(device)
    if isinstance(S, torch.Tensor):
        return S.to(dev)
    return torch.as_tensor(np.asarray(S)).to(dev)


@register_cc_backend("jax")
def _labelprop(S, lam, *, device="cuda", **_opts) -> tuple[np.ndarray, int]:
    from repro_torch.core.components import (
        canonicalize_labels,
        connected_components_labelprop,
    )
    from repro_torch.core.screening import count_edges

    S = to_device(S, device)
    labels = connected_components_labelprop(S, float(lam))
    return canonicalize_labels(labels.cpu().numpy()), count_edges(S, lam)


@register_cc_backend("pallas")
def _threshold_cc(S, lam, *, device="cuda", **_opts) -> tuple[np.ndarray, int]:
    from repro_torch.core.components import canonicalize_labels
    from repro_torch.core.screening import count_edges
    from repro_torch.kernels.threshold_cc import connected_components_kernel

    S = to_device(S, device)
    labels = connected_components_kernel(S, float(lam))
    return canonicalize_labels(labels.cpu().numpy()), count_edges(S, lam)


@register_cc_backend("shard_map")
def _shard_map(S, lam, *, mesh=None, device="cuda", **_opts) -> tuple[np.ndarray, int]:
    from repro_torch.core.components import canonicalize_labels
    from repro_torch.core.distributed import (
        as_mesh,
        components_of_row_shards,
        count_edges_rowsharded,
        local_device_mesh,
        padded_row_shards,
    )

    mesh = local_device_mesh(device) if mesh is None else as_mesh(mesh)
    S_rows = padded_row_shards(S, mesh)
    labels = components_of_row_shards(S_rows, float(lam))[: S.shape[0]]
    # the padded isolated vertices have no edges
    return canonicalize_labels(labels.cpu().numpy()), count_edges_rowsharded(S_rows, lam)
