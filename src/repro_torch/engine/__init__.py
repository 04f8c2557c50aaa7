"""The Plan->Execute engine of the port: options, registries, planner,
executor and ``Engine``."""

from repro_torch.engine.api import Engine, GlassoResult
from repro_torch.engine.options import EngineOptions, normalize_options
from repro_torch.engine.registry import (
    available_cc_backends,
    register_cc_backend,
    route_for,
    set_route,
)

__all__ = [
    "Engine",
    "GlassoResult",
    "EngineOptions",
    "normalize_options",
    "available_cc_backends",
    "register_cc_backend",
    "route_for",
    "set_route",
]
