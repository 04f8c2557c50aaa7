"""Graphical-lasso block solvers behind the Solver protocol.

``bcd`` — GLASSO block coordinate descent, the paper-faithful baseline —
is the one iterative solver of the port so far; a bucket solves in one
``bucket_glasso`` launch.  The reference's ``pg``, ``admm``, ``fused_bcd``
and ``sharded`` specs are not registered yet: asking for one raises the
registry's ``ValueError`` naming the available solvers.
"""

from repro_torch.core.solvers.bcd import glasso_bcd_stack
from repro_torch.core.solvers.closed_form import (
    glasso_chordal_host,
    glasso_forest_stack,
    kkt_ok_stack,
    kkt_residual_host,
)
from repro_torch.core.solvers.kkt import kkt_residual
from repro_torch.core.solvers.protocol import (
    SolverSpec,
    available_solvers,
    register_solver,
    solver_spec,
)

register_solver(
    SolverSpec(
        name="bcd",
        fn=glasso_bcd_stack,
        batched=True,
        warm_startable=True,
        description="GLASSO block coordinate descent (paper baseline)",
        # consumes the Theta-side seed alongside W0 (repairs pass the
        # rejected candidate as Theta0 and its inverse as W0)
        meta={"theta_warm": True},
    )
)


__all__ = [
    "glasso_bcd_stack",
    "glasso_forest_stack",
    "glasso_chordal_host",
    "kkt_ok_stack",
    "kkt_residual",
    "kkt_residual_host",
    "SolverSpec",
    "register_solver",
    "solver_spec",
    "available_solvers",
]
