"""The joint Plan->Execute engine: K-class screen -> plan -> route -> solve.

Mirrors ``repro_torch.engine`` on the class axis, on the device
``EngineOptions.device`` names:

* **Routing ladder.**  "singleton" assembles closed-form (per class
  1/(S_ii + lam1); lam2 never touches the diagonal).  IDENTICAL class
  blocks reduce the joint problem on the component exactly to ONE
  single-class problem at an effective lambda, so they fan out by union
  shape like the single-class ladder: "joint_forest" (the batched forest
  closed form, the ``tree_glasso`` kernel), "joint_chordal" (host
  clique-tree direct solve), "joint_shared" (one single-class ``bcd``
  solve, the ``bucket_glasso`` kernel — 1/K of the coupled work).  The
  reduction,

      fused  lam_eff = lam1            (the symmetric optimum zeroes every
                                        difference; y = 0 is admissible)
      group  lam_eff = lam1 + lam2/sqrt(K)   off-diagonal (the group
                                        subgradient at a symmetric point is
                                        forced to sign/sqrt(K)); the
                                        DIAGONAL keeps lam1, folded in by
                                        shifting the input diagonal by
                                        lam1 - lam_eff before the solve

  is solved once and replicated across classes.  The candidate is accepted
  only on per-class sufficiency: canonical KKT against EVERY class's own
  (shifted) block at lam_eff, so near-identical misroutes can only fall
  back, never corrupt.  "joint_general" (class-specific blocks) takes the
  K-coupled joint ADMM (``joint.admm``, the ``joint_prox`` kernel).

* **Verified, with fallback.**  Every conditional route — the shared
  forest/chordal/single-class candidates — is per-class KKT-certified, and
  rejections re-dispatch to the joint ADMM warm-started from the rejected
  candidate (``joint.fallbacks`` + per-class ``router.fallback.*``).  The
  joint ADMM tail is trusted on convergence, as the single-class tail is;
  ``verify_tail=True`` opts in to the exact host joint-KKT check of every
  tail block (``joint.kkt``; failures re-dispatch with a 10x iteration
  budget, counted as above).

Where the reference fetches jitted, vmapped executables from a compiled
cache (``compiled_joint_solver``, ``compiled_joint_symmetric``), the port
calls the joint solver and ``joint_symmetric_stack`` on the whole bucket
stack: PyTorch runs eagerly, and the batch dimension is written out.
"""

from __future__ import annotations

import inspect
import math
import time
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.core.instrument import bump, timed_dispatch
from repro_torch.core.solvers.closed_form import kkt_ok_stack
from repro_torch.core.solvers.protocol import solver_spec
from repro_torch.core.sparse import resolve_output
from repro_torch.engine.options import EngineOptions, normalize_options
from repro_torch.joint.blocks import (
    JointPlan,
    assemble_joint,
    assemble_joint_sparse,
    build_joint_plan,
)
from repro_torch.joint.kkt import joint_kkt_residual
from repro_torch.joint.screen import (
    JointScreenStats,
    _check_penalty,
    joint_thresholded_components,
)
from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack
from repro_torch.obs.trace import span, trace_request


def joint_effective_lambda(lam1, lam2, K: int, *, penalty: str):
    """Effective single-class lambda of an identical-block joint component."""
    if penalty == "group":
        return lam1 + lam2 / math.sqrt(float(K))
    return lam1 + 0.0 * lam2


def joint_symmetric_stack(
    blocks: torch.Tensor, lam1s: torch.Tensor, lam2s: torch.Tensor, *,
    penalty: str, tol: float, inner: str = "forest", opts: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared-component solver + per-class verifier over a bucket:
    (thetas (n, K, size, size), ok (n,)) — the reference's
    ``compiled_joint_symmetric`` executable.

    ONE single-class solve of the class-mean (diag-shifted) block at
    lam_eff — the forest closed form (``tree_glasso``) for
    ``inner="forest"``, else the named single-class iterative solver (for
    "bcd", ``bucket_glasso``) — replicated across K; ok certifies the
    canonical KKT residual of the SAME candidate against every class's own
    shifted block, which for a symmetric candidate implies JOINT
    optimality."""
    n, K, size, _ = blocks.shape
    lam_eff = joint_effective_lambda(lam1s, lam2s, K, penalty=penalty)
    shift = lam1s - lam_eff  # 0 for fused
    eye = torch.eye(size, dtype=blocks.dtype, device=blocks.device)
    adjusted = blocks + shift[:, None, None, None] * eye
    eff = torch.mean(adjusted, dim=1)
    if inner == "forest":
        theta = glasso_forest_stack(eff, lam_eff)
    else:
        theta = solver_spec(inner).fn(eff, lam_eff, **(opts or {}))
    thetas = theta[:, None].expand(n, K, size, size).contiguous()
    ok = kkt_ok_stack(
        adjusted.reshape(n * K, size, size), torch.repeat_interleave(lam_eff, K),
        thetas.reshape(n * K, size, size), tol=tol,
    ).reshape(n, K).all(dim=1)
    return thetas, ok


def solve_joint_chordal_bucket(
    bucket, plan, *, tol: float
) -> tuple[np.ndarray, np.ndarray]:
    """Host clique-tree direct solve of one identical-block chordal bucket.

    Per block: the class-mean (diag-shifted) sub-block solves ONCE through
    the single-class chordal machinery at lam_eff; the candidate replicates
    across classes and must pass the canonical host KKT against EVERY
    class's own shifted block.  Returns (padded (n, K, size, size) stack,
    per-block ok) — failures join the caller's joint-ADMM fallback."""
    from repro_torch.core.solvers.closed_form import (
        glasso_chordal_host,
        kkt_residual_host,
    )

    n = len(bucket.comps)
    K = plan.K
    lam_eff = float(
        joint_effective_lambda(plan.lam1, plan.lam2, K, penalty=plan.penalty)
    )
    shift = plan.lam1 - lam_eff
    out = np.empty_like(np.asarray(bucket.blocks))
    ok = np.zeros(n, dtype=bool)
    for i, comp in enumerate(bucket.comps):
        b = len(comp)
        cls_blocks = np.asarray(bucket.blocks[i][:, :b, :b], dtype=np.float64)
        cls_blocks = cls_blocks + shift * np.eye(b)
        eff = cls_blocks.mean(axis=0)
        padded = np.broadcast_to(
            np.eye(bucket.size, dtype=out.dtype) / (1.0 + plan.lam1),
            (K, bucket.size, bucket.size),
        ).copy()
        try:
            theta = glasso_chordal_host(eff, lam_eff)
            res = max(
                kkt_residual_host(cls_blocks[k], lam_eff, theta)
                for k in range(K)
            )
            scale = max(1.0, float(np.abs(cls_blocks).max()))
            ok[i] = res <= tol * scale
            padded[:, :b, :b] = theta
        except (ValueError, np.linalg.LinAlgError):
            ok[i] = False
        out[i] = padded
    return out, ok


class JointEngine:
    """Reusable K-class pipeline: fixed (solver, dtype, device, cc_backend,
    route).

    The penalty and (lam1, lam2) are per-call — they are request data, like
    lambda on the single-class path."""

    def __init__(
        self,
        *,
        options: EngineOptions | None = None,
        **legacy_engine_kwargs,
    ):
        """Configured by one ``EngineOptions`` (``options=``); the historical
        kwargs normalize through the shared chokepoint without warning — the
        public ``joint_glasso`` wrapper owns the deprecation signal."""
        opts = normalize_options(
            options, legacy_engine_kwargs, context="JointEngine"
        )
        self.options = opts
        solver = opts.resolved_solver("joint_admm")
        spec = solver_spec(solver)
        if not spec.meta.get("joint"):
            raise ValueError(
                f"solver {solver!r} is not a joint solver (spec.meta['joint'])"
            )
        self.output = opts.output
        self.last_assemble_seconds = 0.0
        self.solver = solver
        self._spec = spec
        self.dtype = opts.resolved_dtype()
        self.np_dtype = opts.np_dtype()
        self.device = opts.resolved_device()
        self.cc_backend = opts.cc_backend
        self.route = opts.route
        self.route_check_tol = opts.route_check_tol
        self.verify_tail = opts.verify_tail
        self.stream = opts.stream
        self.solver_opts = dict(opts.solver_opts)
        # the "joint_shared" rung's single-class solver (identical blocks,
        # general union shape): bcd — the same solver the per-class
        # baseline would pay K times — fed the subset of the joint solver's
        # options it understands (tol travels; admm-specific knobs do not)
        self.effective_solver = "bcd"
        eff_accept = set(
            inspect.signature(solver_spec(self.effective_solver).fn).parameters
        )
        self.effective_opts = {
            k: v for k, v in self.solver_opts.items() if k in eff_accept
        }

    def _trace_ctx(self, name: str, **attrs):
        """Root a request trace — or join the ambient one.
        ``EngineOptions(trace=False)`` keeps the joint engine span-free."""
        if not self.options.trace:
            return nullcontext()
        return trace_request(name, **attrs)

    # -- stages ------------------------------------------------------------

    def screen(
        self, Ss, lam1: float, lam2: float, *, penalty: str
    ) -> tuple[np.ndarray, JointScreenStats]:
        with span("engine.screen", backend=self.cc_backend, kind="joint"):
            return joint_thresholded_components(
                Ss, lam1, lam2, penalty=penalty, backend=self.cc_backend,
                device=self.device,
            )

    def plan(
        self, Ss, lam1: float, lam2: float, labels, *, penalty: str,
        classify: bool | None = None,
    ) -> JointPlan:
        if classify is None:
            classify = self.route
        with span("engine.plan", kind="joint"):
            return build_joint_plan(
                Ss, lam1, lam2, labels, penalty=penalty, dtype=self.np_dtype,
                classify_structures=classify,
            )

    # -- solve -------------------------------------------------------------

    def run(
        self,
        Ss,
        lam1: float,
        lam2: float = 0.0,
        *,
        penalty: str = "group",
        screen: bool = True,
        labels: np.ndarray | None = None,
        screen_stats: JointScreenStats | None = None,
        output: str | None = None,
    ):
        """One joint solve; see ``repro_torch.joint.api.joint_glasso`` for
        the user-facing wrapper and result object."""
        from repro_torch.joint.api import _joint_result

        _check_penalty(penalty)
        Ss = [S if hasattr(S, "gather_block") else np.asarray(S) for S in Ss]
        if len({S.shape for S in Ss}) != 1:
            raise ValueError("all class covariances must share one shape")
        p = Ss[0].shape[0]
        out_mode = resolve_output(self.output if output is None else output, p)
        with self._trace_ctx(
            "engine.joint", lam1=float(lam1), lam2=float(lam2),
            K=len(Ss), p=int(p),
        ):
            screened = True
            if labels is not None:
                labels = np.asarray(labels)
            elif any(hasattr(S, "gather_block") for S in Ss):
                raise ValueError(
                    "materialized covariances cannot be re-screened densely; "
                    "pass the streamed labels (see JointEngine.run_from_data)"
                )
            elif screen:
                labels, screen_stats = self.screen(
                    Ss, lam1, lam2, penalty=penalty
                )
            else:
                labels = np.zeros(p, dtype=np.int64)
                screen_stats = None
                screened = False
            plan = self.plan(
                Ss, lam1, lam2, labels, penalty=penalty,
                classify=self.route and screened,
            )
            t0 = time.perf_counter()
            with span("engine.solve", kind="joint"):
                Theta, fallbacks = self.solve_plan(plan, Ss, output=out_mode)
            seconds = time.perf_counter() - t0
            return _joint_result(
                plan, labels, screen_stats, Theta, seconds, self.solver,
                routed=self.route, fallbacks=fallbacks,
                assemble_seconds=self.last_assemble_seconds,
            )

    def run_from_data(
        self,
        Xs,
        lam1: float,
        lam2: float = 0.0,
        *,
        penalty: str = "group",
        stream=None,
        output: str | None = None,
    ):
        """One joint solve screened straight from the per-class (n_k, p)
        data matrices — no class's dense S ever exists
        (``repro_torch.joint.stream``)."""
        from repro_torch.joint.stream import joint_stream_screen

        if stream is None:
            stream = self.stream
        with self._trace_ctx(
            "engine.joint", lam1=float(lam1), lam2=float(lam2), K=len(Xs),
            source="data",
        ):
            with span("engine.screen", backend="stream", kind="joint"):
                sc = joint_stream_screen(
                    Xs, lam1, lam2, penalty=penalty, config=stream,
                    device=self.device,
                )
            return self.run(
                sc.S, lam1, lam2, penalty=penalty,
                labels=sc.labels, screen_stats=sc.stats, output=output,
            )

    def solve_plan(
        self, plan: JointPlan, Ss, *, output: str = "dense"
    ) -> tuple[np.ndarray, int]:
        """Dispatch every bucket, verify, repair, assemble.

        Returns (Theta, fallbacks for THIS solve): Theta is the dense
        (K, p, p) stack, or a ``JointSparseTheta`` over the bucket solution
        stacks when ``output="sparse"`` (no (K, p, p) allocation)."""
        from repro_torch.engine.registry import route_for

        if self.route and len(plan.isolated):
            bump("router.route.singleton", int(len(plan.isolated)))
        dev, dt = self.device, self.dtype
        pending = []  # (bucket, out, ok)
        for bucket in plan.buckets:
            n = len(bucket.comps)
            route = route_for(bucket.structure) if self.route else "iterative"
            if self.route:
                bump(f"router.route.{bucket.structure}", n)
            if route == "chordal" and bucket.structure == "joint_chordal":
                # host direct solve: no device round-trip for the candidate
                (out, ok), _ = timed_dispatch(
                    solve_joint_chordal_bucket,
                    bucket, plan, tol=self.route_check_tol,
                )
                bump("joint.dispatches")
                bump("joint.closed_form_blocks", n)
                pending.append([bucket, out, ok])
                continue
            stacked = torch.as_tensor(np.asarray(bucket.blocks), dtype=dt, device=dev)
            lam1s = torch.full((n,), plan.lam1, dtype=dt, device=dev)
            lam2s = torch.full((n,), plan.lam2, dtype=dt, device=dev)
            if route == "closed_form" and bucket.structure == "joint_forest":
                (out, ok), _ = timed_dispatch(
                    joint_symmetric_stack, stacked, lam1s, lam2s,
                    penalty=plan.penalty, tol=self.route_check_tol, inner="forest",
                )
                bump("joint.dispatches")
                bump("joint.closed_form_blocks", n)
            elif bucket.structure == "joint_shared" and self.route:
                # identical blocks, general union shape: ONE single-class
                # iterative solve at lam_eff instead of the K-coupled ADMM
                (out, ok), _ = timed_dispatch(
                    joint_symmetric_stack, stacked, lam1s, lam2s,
                    penalty=plan.penalty, tol=self.route_check_tol,
                    inner=self.effective_solver, opts=self.effective_opts,
                )
                bump("joint.dispatches")
                bump("joint.shared_blocks", n)
            else:
                out, _ = timed_dispatch(
                    self._spec.fn, stacked, lam1s, lam2s,
                    penalty=plan.penalty, **self.solver_opts,
                )
                ok = None
                bump("joint.dispatches")
            pending.append([bucket, out, ok])

        # one synchronization point for the primary wave
        with span("engine.barrier"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # verify every bucket, dispatch all repairs, then wait once more
        fallbacks = 0
        solutions = []
        repairs = []  # (solutions index, row idx, re-solve)
        for bucket, out, ok in pending:
            out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
            if ok is not None:  # conditional-route candidates: verdicts
                ok = ok.cpu().numpy() if isinstance(ok, torch.Tensor) else ok
                idx = np.flatnonzero(~np.asarray(ok))
            elif self.verify_tail:  # opt-in: exact host joint-KKT verdicts
                bad = [
                    i
                    for i in range(out.shape[0])
                    if not self._admm_ok(bucket.blocks[i], out[i], plan)
                ]
                idx = np.asarray(bad, dtype=np.int64)
            else:  # the iterative tail is trusted on convergence
                idx = np.empty(0, dtype=np.int64)
            if idx.size:
                fallbacks += int(idx.size)
                bump("joint.fallbacks", int(idx.size))
                bump(f"router.fallback.{bucket.structure}", int(idx.size))
                fixed = self._dispatch_fallback(
                    bucket, plan, np.asarray(bucket.blocks)[idx],
                    np.full(idx.size, plan.lam1), np.full(idx.size, plan.lam2),
                    out[idx],
                )
                out = np.array(out)
                repairs.append((len(solutions), idx, fixed))
            solutions.append(out)
        for pos, idx, fixed in repairs:
            solutions[pos][idx] = fixed.cpu().numpy()
        t0 = time.perf_counter()
        with span("engine.assemble", output=output):
            if output == "sparse":
                Theta = assemble_joint_sparse(plan, solutions, Ss)
            else:
                Theta = assemble_joint(plan, solutions, Ss)
        self.last_assemble_seconds = time.perf_counter() - t0
        bump("engine.assemble_us", int(self.last_assemble_seconds * 1e6))
        return Theta, fallbacks

    def _admm_ok(self, S_stack: np.ndarray, theta: np.ndarray, plan) -> bool:
        scale = max(1.0, float(np.abs(S_stack).max()))
        res = joint_kkt_residual(
            S_stack, theta, plan.lam1, plan.lam2, penalty=plan.penalty
        )
        return res <= self.route_check_tol * scale

    def _dispatch_fallback(
        self, bucket, plan, blocks, lam1s, lam2s, candidates
    ) -> torch.Tensor:
        """Re-dispatch rejected candidates to the joint ADMM, warm-started
        from the rejected candidate (its per-class inverse is the W seed,
        the candidate itself the Theta seed), with a 10x iteration budget
        and 10x tighter tolerance.  With lam2 = 0 this IS K independent
        single-class re-solves (the prox decouples)."""
        opts = dict(self.solver_opts)
        # 10x the configured budget, floored at a full default budget — a
        # starved caller's repair must not inherit the starvation
        opts["max_iter"] = max(10 * int(opts.get("max_iter", 2000)), 5000)
        opts["tol"] = min(float(opts.get("tol", 1e-7)), 1e-7) / 10.0
        dev, dt = self.device, self.dtype
        sub = torch.as_tensor(blocks, dtype=dt, device=dev)
        cand = torch.as_tensor(candidates, dtype=dt, device=dev)
        l1 = torch.as_tensor(lam1s, dtype=dt, device=dev)
        l2 = torch.as_tensor(lam2s, dtype=dt, device=dev)
        W0, info = torch.linalg.inv_ex(cand)
        finite = (
            torch.isfinite(W0).all(dim=(1, 2, 3)) & (info == 0).all(dim=1)
        )[:, None, None, None]
        eye = torch.eye(bucket.size, dtype=dt, device=dev)
        cold_W = sub + l1[:, None, None, None] * eye
        cold_T = torch.diag_embed(
            1.0 / (sub.diagonal(dim1=2, dim2=3) + l1[:, None, None])
        )
        W0 = torch.where(finite, W0, cold_W)
        T0 = torch.where(finite, cand, cold_T)
        bump("joint.dispatches")
        out, _ = timed_dispatch(
            self._spec.fn, sub, l1, l2, penalty=plan.penalty, W0=W0, Theta0=T0, **opts,
        )
        return out
