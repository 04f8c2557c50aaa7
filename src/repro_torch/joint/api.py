"""Public joint graphical-lasso API: thin wrappers over ``JointEngine``.

``joint_glasso([S_1..S_K], lam1, lam2)``   solve the K-class joint problem
    (J) with the exact hybrid covariance thresholding screen (Tang et al.,
    arXiv:1503.02128) on by default — or ``screen=False`` for the
    unscreened baseline arm the equivalence checks compare against.
``joint_glasso(Xs=[X_1..X_K], ..., from_data=True)``   the out-of-core
    path: one streamed screen per class at lam1 (the ``covgram_screen``
    kernel on the card), exact hybrid completion of the candidate pairs,
    per-class materialized component blocks — no class's dense (p, p)
    covariance ever exists.

``penalty`` picks the cross-class coupling: "group" (l2 over classes per
entry) or "fused" (pairwise l1 between classes).  ``lam2=0`` decouples the
problem exactly into K independent ``glasso`` solves.  The solve runs on
``EngineOptions.device`` ("cuda" by default).  Results are dense (K, p, p)
numpy stacks, or a ``JointSparseTheta`` when ``options.output`` resolves to
"sparse" ("auto" does above ``AUTO_SPARSE_P``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.instrument import bump
from repro_torch.core.sparse import JointSparseTheta, result_nbytes
from repro_torch.joint.screen import JointScreenStats

__all__ = ["JointGlassoResult", "joint_glasso"]


@dataclass
class JointGlassoResult:
    lam1: float
    lam2: float
    penalty: str
    Theta: np.ndarray              # (K, p, p) — or a JointSparseTheta when
                                   # output resolved to "sparse"
    labels: np.ndarray             # union-graph partition (canonical)
    screen: JointScreenStats | None
    solve_seconds: float           # dispatch + verify (assembly EXCLUDED)
    solver: str
    block_sizes: list[int] = field(default_factory=list)
    route_mix: dict = field(default_factory=dict)   # joint structure -> #blocks
    routed: bool = True
    fallbacks: int = 0             # verification failures re-dispatched
    assemble_seconds: float = 0.0  # scatter slice of this solve
    bytes_peak: int = 0            # resident bytes of Theta as assembled
    output: str = "dense"          # the representation actually returned
    trace: object | None = None    # request Trace (repro_torch.obs) when traced

    def stages(self) -> dict[str, float]:
        """Seconds per canonical stage — the same view as
        ``GlassoResult.stages()`` (joint solves have no separate dispatch
        ledger: host issue time rides inside ``solve``)."""
        return {
            "screen": (
                float(self.screen.seconds) if self.screen is not None else 0.0
            ),
            "solve": float(self.solve_seconds),
            "dispatch": 0.0,
            "assemble": float(self.assemble_seconds),
        }

    @property
    def K(self) -> int:
        return self.Theta.shape[0]

    @property
    def support(self) -> np.ndarray:
        """Union concentration-graph adjacency (an edge in ANY class).
        Sparse results derive it from per-block nonzeros (dense bool up to
        the densify cap, scipy bool CSR above) — no (p, p) densify."""
        if isinstance(self.Theta, JointSparseTheta):
            return self.Theta.support()
        A = (np.abs(self.Theta) > 0).any(axis=0)
        np.fill_diagonal(A, False)
        return A

    def class_support(self, k: int) -> np.ndarray:
        if isinstance(self.Theta, JointSparseTheta):
            return self.Theta.class_view(k).support()
        A = np.abs(self.Theta[k]) > 0
        np.fill_diagonal(A, False)
        return A

    def support_edges(self) -> np.ndarray:
        """(E, 2) union support edges (upper-triangular, sorted)."""
        if isinstance(self.Theta, JointSparseTheta):
            return self.Theta.support_edges()
        r, c = np.nonzero(np.triu(self.support, k=1))
        return np.stack([r, c], axis=1).astype(np.int64) if r.size else np.zeros(
            (0, 2), dtype=np.int64
        )


def _joint_result(
    plan, labels, screen_stats, Theta, seconds, solver, *,
    routed: bool = True, fallbacks: int = 0, assemble_seconds: float = 0.0,
) -> JointGlassoResult:
    route_mix = {"singleton": len(plan.isolated)} if len(plan.isolated) else {}
    for b in plan.buckets:
        route_mix[b.structure] = route_mix.get(b.structure, 0) + len(b.comps)
    solve_seconds = max(0.0, float(seconds) - float(assemble_seconds))
    bump("engine.solve_us", int(solve_seconds * 1e6))
    from repro_torch.obs.trace import current_trace

    return JointGlassoResult(
        trace=current_trace(),
        lam1=plan.lam1,
        lam2=plan.lam2,
        penalty=plan.penalty,
        Theta=Theta,
        labels=labels,
        screen=screen_stats,
        solve_seconds=solve_seconds,
        solver=solver,
        block_sizes=sorted(
            (len(c) for b in plan.buckets for c in b.comps), reverse=True
        ),
        route_mix=route_mix,
        routed=routed,
        fallbacks=fallbacks,
        assemble_seconds=float(assemble_seconds),
        bytes_peak=result_nbytes(Theta),
        output="sparse" if isinstance(Theta, JointSparseTheta) else "dense",
    )


def joint_glasso(
    Ss=None,
    lam1: float | None = None,
    lam2: float = 0.0,
    *,
    penalty: str = "group",
    Xs=None,
    from_data: bool = False,
    stream=None,
    screen: bool = True,
    options=None,
    **engine_kwargs,
) -> JointGlassoResult:
    """Solve the K-class joint graphical lasso; see the module docstring.

    Engine configuration travels as ``options=EngineOptions(...)``, the same
    typed object ``glasso`` accepts (``options.route=False`` disables the
    joint routing ladder, ``options.cc_backend`` picks the union-graph
    partition backend, ``options.verify_tail=True`` opts in to exact
    joint-KKT verification of the ADMM tail, ``options.device`` picks where
    the solve runs; see ``JointEngine``).  The historical kwarg spelling
    (``route=``, ``verify_tail=``, ``tol=``, ...) still works through the
    shared deprecation layer and raises a ``DeprecationWarning``."""
    from repro_torch.engine.options import normalize_options
    from repro_torch.joint.engine import JointEngine

    opts = normalize_options(
        options, engine_kwargs, warn=True, context="joint_glasso"
    )
    engine = JointEngine(options=opts)
    if from_data or Xs is not None:
        if Xs is None:
            raise ValueError("from_data=True needs the data matrices (Xs=...)")
        if Ss is not None:
            raise ValueError("pass either Ss or Xs=, not both")
        if lam1 is None:
            raise ValueError("joint_glasso needs lam1")
        return engine.run_from_data(
            Xs, float(lam1), float(lam2), penalty=penalty, stream=stream
        )
    if Ss is None or lam1 is None:
        raise ValueError("joint_glasso needs (Ss, lam1) — or Xs=/from_data=True")
    return engine.run(
        Ss, float(lam1), float(lam2), penalty=penalty, screen=screen
    )
