"""The Plan->Execute engine of the port.

Layers:
    registry   screening backends behind one ``backend=`` string + the
               structure -> solver routing ladder + the capability-tagged
               Solver protocol (``SolverSpec``/``register_solver``)
    structure  component subgraph classification feeding the ladder
    planner    one-lambda plans and whole-path planning (one union-find
               pass, lifetime-bucketed diffed plans)
    executor   bucket dispatch on the device, verified closed-form fast
               paths, path warm starts from kept device solutions
    api        the ``Engine`` facade that ``repro_torch.core.glasso`` wraps
"""

from repro_torch.engine.registry import (
    SolverSpec,
    available_cc_backends,
    available_solvers,
    get_cc_backend,
    label_components,
    register_cc_backend,
    register_solver,
    route_for,
    set_route,
    solver_routes,
    solver_spec,
)
from repro_torch.engine.structure import STRUCTURES, classify_component
from repro_torch.engine.planner import (
    PathPlan,
    PathStep,
    bucket_key,
    build_plan_incremental,
    component_lifetimes,
    plan_path,
)
from repro_torch.engine.executor import BucketExecutor
from repro_torch.engine.api import Engine, GlassoResult
from repro_torch.engine.options import EngineOptions, normalize_options

__all__ = [
    "Engine",
    "EngineOptions",
    "GlassoResult",
    "normalize_options",
    "BucketExecutor",
    "PathPlan",
    "PathStep",
    "STRUCTURES",
    "SolverSpec",
    "available_cc_backends",
    "available_solvers",
    "register_solver",
    "solver_spec",
    "bucket_key",
    "build_plan_incremental",
    "component_lifetimes",
    "classify_component",
    "get_cc_backend",
    "label_components",
    "plan_path",
    "register_cc_backend",
    "route_for",
    "set_route",
    "solver_routes",
]
