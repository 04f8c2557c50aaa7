"""Joint multi-class graphical lasso on the port: exact hybrid thresholding
+ a fused/group-penalty solver stack over the Plan->Execute machinery.

    from repro_torch.joint import joint_glasso
    res = joint_glasso([S_1, S_2, S_3], lam1=0.4, lam2=0.1, penalty="group")
    res.Theta        # (K, p, p)
    res.route_mix    # {"singleton": ..., "joint_forest": ..., ...}

Modules: ``screen`` (the Tang et al. exact hybrid rule + union-graph
classifier), ``stream`` (the out-of-core per-class screen), ``admm`` (the
group/fused joint ADMM over the ``kernels/joint_prox`` kernel), ``kkt``
(exact joint-KKT verification), ``blocks``/``engine`` (K-stacked planning
+ the routed executor), ``api`` (``joint_glasso``).
"""

from repro_torch.core.solvers.protocol import SolverSpec, register_solver
from repro_torch.joint.admm import joint_admm, joint_admm_info
from repro_torch.joint.api import JointGlassoResult, joint_glasso
from repro_torch.joint.engine import JointEngine
from repro_torch.joint.kkt import joint_kkt_ok, joint_kkt_residual
from repro_torch.joint.screen import (
    JointScreenStats,
    joint_thresholded_components,
    joint_union_adjacency,
)
from repro_torch.joint.stream import JointStreamScreen, joint_stream_screen

# The joint solver joins the capability-tagged registry: batched=False keeps
# it apart from the single-class solvers (its contract is an (n, K, b, b)
# bucket stack), meta["joint"] is what JointEngine requires, and
# theta_warm lets repairs and fallbacks hand back the Theta seed they hold.
register_solver(
    SolverSpec(
        name="joint_admm",
        fn=joint_admm,
        batched=False,
        warm_startable=True,
        description="group/fused joint ADMM over the K-class stack",
        meta={"joint": True, "theta_warm": True},
    )
)

__all__ = [
    "joint_glasso",
    "JointGlassoResult",
    "JointEngine",
    "joint_admm",
    "joint_admm_info",
    "joint_kkt_residual",
    "joint_kkt_ok",
    "joint_thresholded_components",
    "joint_union_adjacency",
    "JointScreenStats",
    "joint_stream_screen",
    "JointStreamScreen",
]
