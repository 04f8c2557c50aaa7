"""Graphical-lasso block solvers behind the Solver protocol.

Every solver is registered as a capability-tagged ``SolverSpec``
(``protocol.py``, re-exported through ``engine.registry``) and the executor
consults the spec — batched? warm-startable? sharded? — instead of
hard-coded name sets.  The batched contract is
``fn(blocks (N, b, b), lams (N,), *, W0=None, Theta0=None, **opts) -> Theta``:

``bcd``      GLASSO block coordinate descent [Friedman et al. 2007] — the
             paper-faithful baseline; a bucket solves in one
             ``bucket_glasso`` launch.  Consumes W0 plus a Theta0 seed for
             the inner-lasso coefficients.
``fused_bcd`` ``bcd`` with the wave packer forced on (``engine.waves``):
             a plan step's small iterative buckets pack into one
             ``bucket_glasso`` launch a size bin; the same bits as ``bcd``.
``pg``       G-ISTA-style proximal gradient — the first-order stand-in for
             SMACS [Lu 2010]; its step is the ``prox_l1`` kernel.
             Warm-starts from Theta0, not W0.
``admm``     ADMM [Boyd et al. 2011] — batched eigh plus the ``shard_prox``
             kernel for the Z/U tail; the most robust on ill-conditioned
             blocks, the cross-check oracle in tests.  Consumes W0:
             Z0 = W0^{-1}, U0 = (W0 - S)/rho (see admm.py).
``sharded``  matmul-only ADMM for OVERSIZE blocks (``sharded.py``): the
             eigh is replaced by Newton-Schulz + CG inner iterations on the
             row-sharded layout over a mesh of devices.  Different
             calling convention (``ShardedSolve`` result) — reached through
             the executor's "sharded" route, never batched.
"""

from collections.abc import Mapping as _Mapping, Set as _Set

from repro_torch.core.solvers.admm import glasso_admm, glasso_admm_info, glasso_admm_stack
from repro_torch.core.solvers.bcd import glasso_bcd, glasso_bcd_stack
from repro_torch.core.solvers.closed_form import (
    glasso_chordal_host,
    glasso_forest,
    glasso_forest_stack,
    kkt_ok_stack,
    kkt_residual_host,
)
from repro_torch.core.solvers.kkt import kkt_residual
from repro_torch.core.solvers.pg import glasso_pg, glasso_pg_stack
from repro_torch.core.solvers.protocol import (
    SolverSpec,
    available_solvers,
    block_solvers,
    register_solver,
    solver_spec,
    warm_start_solvers,
)
from repro_torch.core.solvers.sharded import ShardedSolve, glasso_sharded

register_solver(
    SolverSpec(
        name="bcd",
        fn=glasso_bcd_stack,
        batched=True,
        warm_startable=True,
        description="GLASSO block coordinate descent (paper baseline)",
        # consumes the Theta-side seed alongside W0 (repairs pass the
        # rejected candidate as Theta0 and its inverse as W0); fused_stack:
        # the bucket_glasso kernel solves a packed megabatch with this
        # solver's exact arithmetic, so the wave packer may fuse its buckets
        meta={"theta_warm": True, "fused_stack": True},
    )
)
register_solver(
    SolverSpec(
        name="fused_bcd",
        fn=glasso_bcd_stack,
        batched=True,
        warm_startable=True,
        description="bcd with the wave packer forced on: small iterative "
                    "buckets fuse into one bucket_glasso launch per bin; "
                    "blocks above the last bin dispatch as plain bcd",
        # force_fused: picking this solver turns the packer on under
        # EngineOptions(fused="auto"); the same bits as "bcd".
        # max_fused_size is the largest bin the packer may pad into
        meta={
            "theta_warm": True,
            "fused_stack": True,
            "force_fused": True,
            "max_fused_size": 64,
        },
    )
)
register_solver(
    SolverSpec(
        name="pg",
        fn=glasso_pg_stack,
        batched=True,
        warm_startable=False,  # accepts W0 for parity; warm-starts via Theta0
        description="G-ISTA proximal gradient (SMACS stand-in)",
    )
)
register_solver(
    SolverSpec(
        name="admm",
        fn=glasso_admm_stack,
        batched=True,
        warm_startable=True,
        description="ADMM (eigh Theta-update); the test oracle",
        # consumes the Theta-side seed alongside W0: callers holding the
        # Theta iterate (repairs) skip admm's inv(W0)
        meta={"theta_warm": True},
    )
)
register_solver(
    SolverSpec(
        name="sharded",
        fn=glasso_sharded,
        batched=False,
        warm_startable=True,
        sharded=True,
        description="row-sharded matmul-only ADMM for oversize blocks (no eigh)",
        meta={"warm_kwarg": "Theta0"},
    )
)


class _BlockSolversView(_Mapping):
    """LIVE name -> fn view of the registry's user-pickable block solvers:
    re-derived from the specs on every access, so a solver registered later
    is visible too."""

    def __getitem__(self, name):
        return block_solvers()[name]

    def __iter__(self):
        return iter(block_solvers())

    def __len__(self):
        return len(block_solvers())


class _WarmStartView(_Set):
    """LIVE view of batched solvers that genuinely consume a W0 warm start
    (the sharded solver's Theta0 warm start rides its own dispatch path)."""

    def _names(self):
        return available_solvers(batched=True, warm_startable=True)

    def __contains__(self, name):
        return name in self._names()

    def __iter__(self):
        return iter(self._names())

    def __len__(self):
        return len(self._names())


#: user-pickable single-device block solvers (live registry view)
SOLVERS = _BlockSolversView()

# Closed-form direct solvers are NOT in SOLVERS: they are exact only on the
# structure classes the planner certifies, so they are reached through the
# routing ladder (engine.registry.route_for), never picked for arbitrary
# blocks.
CLOSED_FORM_SOLVERS = {
    "forest": glasso_forest,
    "chordal": glasso_chordal_host,
}

#: batched solvers whose W0 covariance warm start is genuinely consumed
WARM_START_SOLVERS = _WarmStartView()

__all__ = [
    "glasso_bcd",
    "glasso_pg",
    "glasso_admm",
    "glasso_bcd_stack",
    "glasso_pg_stack",
    "glasso_admm_stack",
    "glasso_admm_info",
    "glasso_sharded",
    "ShardedSolve",
    "glasso_forest",
    "glasso_forest_stack",
    "glasso_chordal_host",
    "kkt_ok_stack",
    "kkt_residual",
    "kkt_residual_host",
    "SolverSpec",
    "register_solver",
    "solver_spec",
    "available_solvers",
    "block_solvers",
    "warm_start_solvers",
    "SOLVERS",
    "CLOSED_FORM_SOLVERS",
    "WARM_START_SOLVERS",
]
