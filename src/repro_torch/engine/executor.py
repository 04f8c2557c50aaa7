"""Bucket executor: dispatch every bucket -> (only then) wait -> verify ->
assemble.

* **Routes.**  Each bucket carries the structure class the planner assigned;
  ``registry.route_for`` maps it to "closed_form" (pair/tree: the
  ``tree_glasso`` kernel plus a batched KKT check), "chordal" (host
  clique-tree solve) or "iterative" (the configured solver; for ``bcd`` one
  ``bucket_glasso`` launch per bucket).  Singletons are assembled in closed
  form.
* **Asynchronous dispatch.**  On the card every launch is queued on the
  current stream; the executor waits once, after the last bucket, before it
  reads the KKT verdicts and assembles.
* **Placement.**  On a mesh of several devices (``devices``; the default
  is ``local_device_mesh(device)``: every card for ``"cuda"``) the buckets
  are LPT-placed by their route-aware device cost (``_bucket_cost``,
  ``_place``: chordal, sharded and assembled buckets cost nothing there,
  closed form n b^2, iterative n b^3); each bucket's stack, lambda vector,
  warm start, fused megabatch and repair live on its shard's device, a
  shard's megabatches are its own (also where the mesh repeats a device),
  and a reused stack that LPT moved to another shard is copied there
  (``send``).  The oversize route
  spans the whole mesh.  One device: no placement, the bits of the
  one-device path.
* **Verified routing.**  Closed-form candidates whose KKT residual exceeds
  ``route_check_tol`` (scaled by max(1, max|S|)) are re-solved by the
  iterative solver warm-started from the rejected candidate
  (``dispatch_repair``; ``router.fallback.*`` counters).  Routing changes
  cost, never the answer.
* **Path warm starts.**  Along a lambda path (``Engine.run_path``) a
  bucket the planner carried over keeps its padded stack on the device
  (no re-upload) and warm-starts from its own previous solution, also kept
  on the device: W0 = inv(prev Theta), batched, with the previous Theta as
  the inner-lasso seed; a merged bucket gathers T0 from the previous
  result's blocks and starts from W0 = inv(T0).  A reused oversize bucket
  hands its previous block to the sharded solve as Theta0.
* **Oversize blocks.**  Buckets classed "oversize" take the "sharded"
  route: one blocking ``glasso_sharded`` solve per block over the mesh,
  issued after the asynchronous small buckets are in flight, with its own
  in-place KKT verdict and the same fallback (``solve_sharded_bucket``).
* **Wave packer.**  With ``fused`` on (``EngineOptions(fused=True)``, the
  ``fused_bcd`` solver) or for buckets routed "fused", every iterative
  bucket small enough for a bin (``engine.waves``) is deferred; after the
  bucket loop each occupied bin is solved by ONE ``bucket_glasso`` launch
  over the re-padded lanes of every bucket in it, and each bucket gets its
  slice back.  Packing changes the launches, never a lane's bits.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import blocks as blocks_mod
from repro_torch.core.distributed import as_mesh, local_device_mesh, replica, send
from repro_torch.core.instrument import bump, timed_dispatch
from repro_torch.core.schedule import lpt_assign
from repro_torch.core.solvers import bcd, solver_spec
from repro_torch.core.solvers.closed_form import (
    glasso_chordal_host,
    glasso_forest_stack,
    kkt_ok_stack,
    kkt_residual_host,
)
from repro_torch.engine.options import resolve_device
from repro_torch.engine.registry import route_for
from repro_torch.engine.waves import fused_bin, repad_stack
from repro_torch.obs.trace import span


def _validate_solver_opts(solver: str, opts: dict) -> None:
    """Reject unknown solver kwargs up front."""
    params = inspect.signature(solver_spec(solver).fn).parameters
    accepted = {
        n for n, p in params.items() if p.kind == p.KEYWORD_ONLY
    } - {"W0", "Theta0"}
    unknown = sorted(set(opts) - accepted)
    if unknown:
        raise TypeError(
            f"solver {solver!r} does not accept option(s) {unknown}; "
            f"accepted: {sorted(accepted)}"
        )


def closed_form(
    blocks: torch.Tensor, lams: torch.Tensor, *, tol: float, verify: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form forest solve + KKT verdict: (Theta, ok).

    ``verify=False`` returns ok=True without the check — sound only for the
    "pair" class, whose 2x2 support is complete (no non-edge constraint)."""
    thetas = glasso_forest_stack(blocks, lams)
    if verify:
        ok = kkt_ok_stack(blocks, lams, thetas, tol=tol)
    else:
        ok = torch.ones(blocks.shape[0], dtype=torch.bool, device=blocks.device)
    return thetas, ok


def dispatch_repair(
    solver: str,
    dtype: torch.dtype,
    device: torch.device,
    opts: dict,
    size: int,
    blocks: np.ndarray,
    lams: np.ndarray,
    candidates,
) -> torch.Tensor:
    """Re-solve rejected fast-path blocks with the iterative tail.

    The rejected candidate is usually PD but dual-infeasible, so its inverse
    is a good W iterate and, for solvers consuming the Theta seed, the
    candidate itself seeds the inner lasso.  A candidate that is singular
    or not finite gets the cold pair (S + lam*I, diag(1/(S_ii + lam)))."""
    spec = solver_spec(solver)
    sub = torch.as_tensor(np.asarray(blocks), dtype=dtype, device=device)
    lams_d = torch.as_tensor(np.asarray(lams), dtype=dtype, device=device)
    W0 = T0 = None
    if spec.warm_startable:
        eye = torch.eye(size, dtype=dtype, device=device)
        cand = torch.as_tensor(candidates, dtype=dtype, device=device)
        W0, info = torch.linalg.inv_ex(cand)
        finite = (
            torch.isfinite(W0).all(dim=(1, 2)) & (info == 0)
        )[:, None, None]
        W0 = torch.where(finite, W0, sub + lams_d[:, None, None] * eye)
        if spec.meta.get("theta_warm"):
            diag = sub.diagonal(dim1=1, dim2=2)
            cold_T = torch.diag_embed(1.0 / (diag + lams_d[:, None]))
            T0 = torch.where(finite, cand, cold_T)
    bump("executor.dispatches")
    out, _ = timed_dispatch(spec.fn, sub, lams_d, W0=W0, Theta0=T0, **opts)
    return out


def solve_sharded_bucket(
    bucket: blocks_mod.Bucket,
    lams: np.ndarray,
    S,
    *,
    solver: str,
    dtype: torch.dtype,
    device: torch.device,
    opts: dict,
    tol: float,
    warm_thetas: list | None = None,
    mesh=None,
) -> tuple[np.ndarray, dict]:
    """Mesh-spanning solve of one oversize bucket (route "sharded").

    Per block: shard-direct gather into the row shards of ``mesh``
    (``local_device_mesh(device)`` by default;
    ``stream.materialize.shard_gather``: the (b, b) block arrives row
    chunk by row chunk, a full host copy never exists), the sharded ADMM
    (``core.solvers.glasso_sharded``) and its in-place KKT verdict.  Blocks
    whose residual exceeds ``tol * max(1, max|S|)`` fall back to the
    engine's iterative ``solver`` warm-started from the rejected candidate
    (the shared ``dispatch_repair``), counted loudly:
    ``solver.oversize.fallbacks`` + ``router.fallback.oversize``.  Returns
    (padded (n, size, size) Theta stack, info dict {dispatched,
    inner_iters, fallbacks} for ``GlassoResult.oversize``)."""
    from repro_torch.core.solvers.sharded import glasso_sharded
    from repro_torch.stream.materialize import shard_gather

    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    mesh = local_device_mesh(device) if mesh is None else as_mesh(mesh)
    n = len(bucket.comps)
    out = np.zeros((n, bucket.size, bucket.size), dtype=np_dtype)
    info = {"dispatched": 0, "inner_iters": 0, "fallbacks": 0}
    failed: list[int] = []
    for i, comp in enumerate(bucket.comps):
        b = len(comp)
        lam = float(lams[i])
        S_sh = shard_gather(S, comp, mesh, dtype=np_dtype)
        theta0 = None if warm_thetas is None else warm_thetas[i]
        res, _ = timed_dispatch(
            glasso_sharded, S_sh, lam, mesh=mesh, b=b, Theta0=theta0, kkt_target=tol,
        )
        del S_sh
        info["dispatched"] += 1
        info["inner_iters"] += res.inner_iters
        padded = np.eye(bucket.size, dtype=np_dtype) / (1.0 + lam)
        padded[:b, :b] = res.Theta
        out[i] = padded
        scale = max(1.0, res.s_max)
        if not res.kkt_residual <= tol * scale:  # NaN-safe: not (nan <= x)
            failed.append(i)
    if failed:
        idx = np.asarray(failed)
        info["fallbacks"] = int(idx.size)
        bump("solver.oversize.fallbacks", int(idx.size))
        bump(f"router.fallback.{bucket.structure}", int(idx.size))
        blocks = np.stack([
            blocks_mod.pad_block(
                blocks_mod.gather_submatrix(S, bucket.comps[k], dtype=np_dtype),
                bucket.size,
            )
            for k in idx
        ])
        fixed = dispatch_repair(
            solver, dtype, device, opts, bucket.size, blocks,
            np.asarray(lams)[idx], out[idx],
        )
        out[idx] = fixed.cpu().numpy()
    return out, info


def solve_chordal_bucket(
    bucket: blocks_mod.Bucket, lams: np.ndarray, *, tol: float
) -> tuple[np.ndarray, np.ndarray]:
    """Host clique-tree direct solve of one chordal bucket.

    Returns (padded Theta stack, per-block ok); verification failures are
    left to the caller's fallback."""
    n = bucket.blocks.shape[0]
    thetas = np.empty_like(np.asarray(bucket.blocks))
    ok = np.zeros(n, dtype=bool)
    for i, comp in enumerate(bucket.comps):
        b = len(comp)
        lam = float(lams[i])
        blk = np.asarray(bucket.blocks[i][:b, :b])
        padded = np.eye(bucket.size, dtype=thetas.dtype) / (1.0 + lam)
        try:
            theta = glasso_chordal_host(blk, lam)
            res = kkt_residual_host(blk, lam, theta)
            scale = max(1.0, float(np.abs(blk).max()))
            ok[i] = res <= tol * scale
            padded[:b, :b] = theta
        except (ValueError, np.linalg.LinAlgError):
            ok[i] = False
        thetas[i] = padded
    return thetas, ok


@dataclass
class _Pending:
    bucket: blocks_mod.Bucket
    out: Any                       # tensor (device routes) or np (chordal)
    ok: Any = None                 # per-block KKT flags of verified routes
    repair: Any = None             # (row idx, in-flight iterative re-solve)
    stacked: Any = None            # the device block stack (device routes)
    key: Any = None                # planner.bucket_key of the bucket
    warm: bool = False             # iterative solve from a warm (W0, T0)
    host: Any = None               # host copy of ``out``, once read
    device: Any = None             # where the bucket's stacks lie (placement)
    shard: int | None = None       # its worker index on the mesh (None: one device)


@dataclass
class _FusedLane:
    """One fused-eligible bucket deferred into a bin's megabatch; its
    ``pending.out`` receives the bucket's (n, size, size) slice of the
    packed result."""

    pending: _Pending
    size: int                      # source bucket size (bin >= size)
    n: int                         # blocks in the bucket
    lams: torch.Tensor             # (n,) lambda vector on the device
    W0: torch.Tensor | None = None  # warm covariance stack, None when cold
    T0: torch.Tensor | None = None  # warm Theta stack, None when cold


@dataclass
class BucketExecutor:
    """Solves plans on a mesh of devices (one device by default on a host
    with one card)."""

    solver: str = "bcd"
    dtype: torch.dtype = torch.float64
    device: Any = "cuda"           # resolved as EngineOptions.device is
    solver_opts: dict = field(default_factory=dict)
    # the mesh buckets are placed on and the oversize route spans: a
    # sequence of CUDA or CPU devices (one may repeat); None is
    # local_device_mesh(device)
    devices: Any = None
    route: bool = True             # structure-routed ladder; False = all iterative
    route_check_tol: float = 1e-6  # KKT acceptance for closed-form candidates
    # wave packer: fuse every small iterative bucket of a plan into one
    # bucket_glasso launch per size bin (resolved by the Engine from
    # EngineOptions.fused; buckets routed "fused" fuse regardless)
    fused: bool = False
    # assembly-stage seconds of the MOST RECENT solve_plan call
    last_assemble_seconds: float = 0.0
    # host seconds spent issuing launches in the MOST RECENT solve_plan call
    last_dispatch_seconds: float = 0.0
    # oversize accounting of the MOST RECENT solve_plan call (dispatched /
    # inner_iters / fallbacks), surfaced as GlassoResult.oversize
    last_oversize: dict = field(default_factory=dict)
    # bucket_key -> previous padded solution / input stack (device tensors),
    # kept by solve_plan(keep_solutions=True): a reused bucket warm-starts
    # from its own solution and skips the host-to-device copy of its blocks
    _prev_solutions: dict = field(default_factory=dict)
    _prev_blocks: dict = field(default_factory=dict)
    _prev_shards: dict = field(default_factory=dict)  # bucket_key -> worker index

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.devices = (
            local_device_mesh(self.device) if self.devices is None else as_mesh(self.devices)
        )
        self._spec = solver_spec(self.solver)  # unknown names raise ValueError
        _validate_solver_opts(self.solver, self.solver_opts)
        self._np_dtype = np.dtype(str(self.dtype).removeprefix("torch."))
        # fused eligibility: the solver declares the fused_stack capability
        # AND every solver opt is one the kernel replays (anything else would
        # silently change the packed solve)
        self._fused_capable = bool(self._spec.meta.get("fused_stack")) and set(
            self.solver_opts
        ) <= {"max_sweeps", "n_cd", "tol", "node_screen"}

    # -- placement ---------------------------------------------------------

    def _bucket_cost(self, bucket: blocks_mod.Bucket) -> float:
        """Estimated DEVICE solve cost of one bucket by its route, not its
        size alone: a chordal bucket solves on the host and an oversize
        one spans the whole mesh (0 here), a closed-form bucket is one
        elementwise pass (n b^2), and only the iterative tail pays b^3 a
        block on its device (n b^3)."""
        route = route_for(bucket.structure) if self.route else "iterative"
        n = len(bucket.comps)
        if route in ("chordal", "sharded", "assemble"):
            return 0.0
        if route == "closed_form":
            return n * float(bucket.size) ** 2
        return n * float(bucket.size) ** 3

    def _place(self, buckets: list[blocks_mod.Bucket], priorities=None) -> list:
        """LPT assignment of buckets to the mesh's devices by estimated
        cost: each bucket's worker index into ``devices`` (the reference's
        ``_place`` returns the device itself), None for every bucket on a
        one-device mesh (the executor's own device).  ``priorities`` (per
        bucket, higher = more urgent) seats urgent buckets first, at the
        front of each device's queue."""
        if len(self.devices) <= 1 or not buckets:
            return [None] * len(buckets)
        cost = [self._bucket_cost(b) for b in buckets]
        assign = lpt_assign(cost, len(self.devices), cost=float, priorities=priorities)
        return [int(w) for w in assign.worker_of]

    # -- warm starts -------------------------------------------------------

    def _gather_stack(self, src, bucket: blocks_mod.Bucket, device=None) -> torch.Tensor:
        """The padded restrictions of ``src`` (a dense (p, p) array or a
        block-sparse result) to the bucket's components, on ``device``
        (the executor's by default)."""
        stacks = [
            blocks_mod.pad_block(
                blocks_mod.gather_submatrix(src, c, dtype=self._np_dtype), bucket.size
            )
            for c in bucket.comps
        ]
        return torch.as_tensor(np.stack(stacks), dtype=self.dtype, device=device or self.device)

    def _warm_stack(
        self,
        bucket: blocks_mod.Bucket,
        key,
        lam: float,
        warm_W,
        warm_Theta=None,
        device=None,
    ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """(W0 stack, Theta0 stack or None) for one bucket, or (None, None).

        A reused bucket with a kept solution: W0 = inv(prev Theta), batched
        on the device (the padded block of Theta is diagonal, so the inverse
        is finite; its padded diagonal is reset to 1 + lam below), and the
        previous Theta rides along as the Theta0 seed (on ``device``, the
        bucket's placement, copied there if LPT moved it).  A merged or fresh
        bucket prefers ``warm_Theta`` (the previous result, dense or
        block-sparse: its cross-component entries are exact zeros, so each
        gathered restriction is the Theorem-2 block-diagonal PD warm
        start): T0 is gathered once and W0 = inv(T0) computed batched on
        the device.  ``warm_W`` (a caller's W iterate, no Theta) is the
        last resort: no Theta seed then."""
        device = device or self.device
        T0 = None
        prev = self._prev_solutions.get(key) if key is not None else None
        if prev is not None:
            T0 = replica(prev, device)
            W0 = torch.linalg.inv(T0)
        elif warm_Theta is not None:
            # pad_block puts the identity on the padded diagonal of T0, so
            # the batched inverse is finite
            T0 = self._gather_stack(warm_Theta, bucket, device)
            W0 = torch.linalg.inv(T0)
        elif warm_W is not None:
            W0 = self._gather_stack(warm_W, bucket, device)
        else:
            return None, None
        # the padded coordinates of a W iterate: diagonal 1 + lam (diagonal
        # KKT), cross terms 0
        idx = torch.arange(bucket.size, device=device)
        pad_mask = torch.stack([idx >= len(c) for c in bucket.comps])
        eye = torch.eye(bucket.size, dtype=torch.bool, device=device)
        fix = pad_mask[:, :, None] & eye[None, :, :]
        W0 = torch.where(fix, torch.tensor(1.0 + lam, dtype=W0.dtype, device=device), W0)
        off = pad_mask[:, :, None] ^ pad_mask[:, None, :]
        return torch.where(off, torch.zeros((), dtype=W0.dtype, device=device), W0), T0

    def solve_plan(
        self,
        plan: blocks_mod.Plan,
        lam: float,
        S: np.ndarray,
        *,
        warm_W=None,
        warm_Theta=None,
        reused_keys: frozenset = frozenset(),
        keep_solutions: bool = False,
        output: str = "dense",
        priorities=None,
    ):
        """Dispatch all buckets, wait once, verify, then assemble Theta.

        ``priorities`` (optional, per bucket, higher = more urgent) makes
        the placement on a mesh of several devices priority-aware (see
        ``_place``).

        ``output="dense"`` scatters into a (p, p) array; ``"sparse"`` hands
        the per-bucket solution stacks, as they came back from the device,
        to ``blocks.assemble_sparse``: a ``SparseTheta`` whose blocks are
        those arrays (no further copy), and no (p, p) buffer is allocated.

        ``reused_keys`` marks buckets the planner carried over from the
        previous lambda: their device stacks and (when the previous call
        kept them, ``keep_solutions``) their solutions seed this solve.
        ``warm_Theta`` is the previous result, gathered for merged buckets;
        ``warm_W`` a caller's W iterate.  ``keep_solutions=False`` drops
        whatever the previous call kept."""
        from repro_torch.engine.planner import bucket_key

        if self.route and len(plan.isolated):
            bump("router.route.singleton", int(len(plan.isolated)))
        self.last_dispatch_seconds = 0.0
        self.last_oversize = {}
        opts = dict(self.solver_opts)
        pending: list[_Pending] = []
        sharded_pending: list[_Pending] = []
        fused_groups: dict[tuple, list[_FusedLane]] = {}
        for bucket, w in zip(plan.buckets, self._place(plan.buckets, priorities=priorities)):
            dev = self.device if w is None else self.devices[w]
            key = bucket_key(bucket)
            n = len(bucket.comps)
            route = route_for(bucket.structure) if self.route else "iterative"
            if self.route:
                bump(f"router.route.{bucket.structure}", n)
            if route == "sharded":
                # blocking solves: queued after the asynchronous small
                # buckets below, so their launches are in flight first
                p = _Pending(bucket=bucket, out=None, key=key, device=self.device)
                pending.append(p)
                sharded_pending.append(p)
                continue
            if route == "chordal":
                # host solve: KKT failures are known at once, so their repair
                # joins the same wave of launches as everything else
                (out, ok), _ = timed_dispatch(
                    solve_chordal_bucket, bucket, np.full(n, lam),
                    tol=self.route_check_tol,
                )
                p = _Pending(bucket=bucket, out=out, key=key, device=self.device)
                if not ok.all():
                    idx = np.flatnonzero(~ok)
                    bump(f"router.fallback.{bucket.structure}", int(idx.size))
                    p.repair = self._dispatch_repair(bucket, idx, out[idx], lam)
                pending.append(p)
                continue
            stacked = self._prev_blocks.get(key) if key in reused_keys else None
            if stacked is None:
                stacked = torch.as_tensor(bucket.blocks, dtype=self.dtype, device=dev)
            elif w != self._prev_shards.get(key):
                # LPT may move a reused bucket to another shard between
                # lambdas: a copy there (a peer copy between cards, a device
                # copy on one) still beats re-uploading from the host
                stacked = send(stacked, dev)
            lams = torch.full((n,), lam, dtype=self.dtype, device=dev)
            if route == "closed_form":
                (theta, ok), dt = timed_dispatch(
                    closed_form, stacked, lams, tol=self.route_check_tol,
                    verify=bucket.structure != "pair",
                )
                self.last_dispatch_seconds += dt
                bump("executor.dispatches")
                pending.append(_Pending(bucket=bucket, out=theta, ok=ok, stacked=stacked, key=key,
                                        device=dev, shard=w))
                continue
            W0 = T0 = None
            if self._spec.warm_startable:
                W0, T0 = self._warm_stack(
                    bucket, key if key in reused_keys else None, lam, warm_W, warm_Theta,
                    device=dev,
                )
            if not self._spec.meta.get("theta_warm"):
                T0 = None
            fuse = (
                route == "fused" or (route == "iterative" and self.fused)
            ) and self._fused_capable
            bin_ = fused_bin(bucket.size) if fuse else None  # None: too big
            if bin_ is not None:
                # wave packer: defer into the (shard, bin) megabatch,
                # launched once a group after this loop (a shard's groups
                # stay its own where the mesh repeats a device)
                p = _Pending(bucket=bucket, out=None, stacked=stacked, key=key,
                             warm=W0 is not None, device=dev, shard=w)
                pending.append(p)
                fused_groups.setdefault((w or 0, bin_), []).append(
                    _FusedLane(pending=p, size=bucket.size, n=n, lams=lams, W0=W0, T0=T0)
                )
                continue
            out, dt = timed_dispatch(self._spec.fn, stacked, lams, W0=W0, Theta0=T0, **opts)
            self.last_dispatch_seconds += dt
            bump("executor.dispatches")
            pending.append(
                _Pending(bucket=bucket, out=out, stacked=stacked, key=key, warm=W0 is not None,
                         device=dev, shard=w)
            )

        fused_sweeps = self._dispatch_fused(fused_groups, lam)

        # oversize buckets: one blocking sharded solve per block over the
        # mesh, while the small launches above are in flight.  A bucket reused from the
        # previous lambda seeds Theta0 with its own previous block (kept on
        # the device), never a host inversion of the giant block.
        totals = {"dispatched": 0, "inner_iters": 0, "fallbacks": 0}
        for p in sharded_pending:
            n = len(p.bucket.comps)
            prev = self._prev_solutions.get(p.key) if p.key in reused_keys else None
            warm_thetas = None
            if prev is not None:
                warm_thetas = [prev[i, : len(c), : len(c)] for i, c in enumerate(p.bucket.comps)]
            p.out, info = solve_sharded_bucket(
                p.bucket, np.full(n, lam), S, solver=self.solver, dtype=self.dtype,
                device=self.device, opts=opts, tol=self.route_check_tol,
                warm_thetas=warm_thetas, mesh=self.devices,
            )
            for k in totals:
                totals[k] += info[k]
        if totals["dispatched"]:
            self.last_oversize = totals

        # single synchronization point: everything above was queued
        with span("engine.barrier"):
            for dev in {self.device, *(p.device for p in pending)}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        for sw in fused_sweeps:
            # what the megabatch's slowest lane would have cost every other
            # lane had they iterated in lockstep without per-lane exit
            sw = sw.cpu()
            if sw.numel():
                bump(
                    "solver.fused.lockstep_sweeps_saved",
                    int(sw.max()) * int(sw.numel()) - int(sw.sum()),
                )
        for p in pending:
            if p.repair is not None:
                idx, fixed = p.repair
                p.out[idx] = fixed.cpu().numpy()
        self._verify_and_fallback(pending, lam)
        self._repair_diverged(pending, lam)

        # the kept solutions are the verified (post-fallback) ones, on the
        # device; a call without keep_solutions frees the previous ones
        new_solutions: dict = {}
        new_blocks: dict = {}
        new_shards: dict = {}
        if keep_solutions:
            for p in pending:
                new_solutions[p.key] = torch.as_tensor(p.out, dtype=self.dtype, device=p.device)
                if p.stacked is not None:
                    new_blocks[p.key] = p.stacked
                    new_shards[p.key] = p.shard
        self._prev_solutions = new_solutions
        self._prev_blocks = new_blocks
        self._prev_shards = new_shards

        t0 = time.perf_counter()
        with span("engine.assemble", output=output):
            sols = [
                p.host if p.host is not None
                else p.out.cpu().numpy() if isinstance(p.out, torch.Tensor) else p.out
                for p in pending
            ]
            if output == "sparse":
                Theta = blocks_mod.assemble_sparse(plan, sols, S)
            else:
                Theta = blocks_mod.assemble_dense(plan, sols, S)
        self.last_assemble_seconds = time.perf_counter() - t0
        bump("engine.assemble_us", int(self.last_assemble_seconds * 1e6))
        return Theta

    def _dispatch_fused(self, groups: dict[tuple, list[_FusedLane]], lam: float) -> list:
        """Launch every (shard, bin) megabatch: ONE ``bucket_glasso``
        launch a group, on the device its lanes were placed on, its result
        sliced back into each lane's ``pending.out``.

        Packing is bitwise-transparent (``engine.waves``): blocks re-pad
        with an identity diagonal, W stacks with 1 + lam, cold lanes carry
        the pair the unfused solve builds (W0 = S + lam*I at the source
        size, Theta0 = I), and each lane's convergence scale is computed on
        its own bucket's stack, as the unfused solve computes it.  Returns
        the launches' sweep counts, read after the barrier for
        ``solver.fused.lockstep_sweeps_saved``.  A launch that fails
        raises: nothing falls back to unfused dispatch."""
        sweeps_out = []
        for (_, bin_), lanes in sorted(groups.items()):
            blk_p, lam_p, sc_p, w_p, t_p = [], [], [], [], []
            for ln in lanes:
                stacked = ln.pending.stacked
                eye = torch.eye(ln.size, dtype=self.dtype, device=stacked.device)
                blk_p.append(repad_stack(stacked, bin_, 1.0))
                lam_p.append(ln.lams)
                sc_p.append(bcd.convergence_scale(stacked))
                # a cold lane: the unfused solve's own W0 at the source size
                w = stacked + ln.lams[:, None, None] * eye if ln.W0 is None else ln.W0
                w_p.append(repad_stack(w, bin_, 1.0 + lam))
                t = eye.expand(ln.n, ln.size, ln.size) if ln.T0 is None else ln.T0
                t_p.append(repad_stack(t, bin_, 1.0))
            # bcd.fused_bcd_stack looked up at call time: the launch
            # counters' wrappers patch it
            (theta, sweeps), dt = timed_dispatch(
                bcd.fused_bcd_stack, *(torch.cat(xs) for xs in (blk_p, lam_p, sc_p, w_p, t_p)),
                **self.solver_opts,
            )
            self.last_dispatch_seconds += dt
            bump("executor.dispatches")
            bump("solver.fused.dispatches")
            bump("solver.fused.blocks_packed", sum(ln.n for ln in lanes))
            off = 0
            for ln in lanes:
                ln.pending.out = theta[off:off + ln.n, :ln.size, :ln.size]
                off += ln.n
            sweeps_out.append(sweeps)
        return sweeps_out

    def _dispatch_repair(
        self, bucket: blocks_mod.Bucket, idx: np.ndarray, candidates, lam: float,
        device=None,
    ):
        """Bucket-shaped wrapper over the shared ``dispatch_repair``, on
        ``device`` (the bucket's placement; the executor's by default)."""
        t0 = time.perf_counter()
        out = dispatch_repair(
            self.solver, self.dtype, device or self.device, dict(self.solver_opts),
            bucket.size, np.asarray(bucket.blocks)[idx],
            np.full(int(idx.size), lam), candidates,
        )
        self.last_dispatch_seconds += time.perf_counter() - t0
        return (idx, out)

    def _verify_and_fallback(self, pending: list[_Pending], lam: float) -> None:
        """Re-solve every closed-form block whose KKT check failed with the
        iterative tail and splice the repaired rows into the stacks."""
        repairs = []
        for p in pending:
            if p.ok is None:
                continue
            ok = p.ok.cpu().numpy()
            if ok.all():
                continue
            idx = np.flatnonzero(~ok)
            bump(f"router.fallback.{p.bucket.structure}", int(idx.size))
            cand = p.out[torch.as_tensor(idx, device=p.out.device)]
            repairs.append((p, self._dispatch_repair(p.bucket, idx, cand, lam, p.device)))
        for p, (idx, fixed) in repairs:
            out = p.out.clone()
            out[torch.as_tensor(idx, device=out.device)] = fixed
            p.out = out

    def _repair_diverged(self, pending: list[_Pending], lam: float) -> None:
        """Re-solve cold every warm-started lane that came back non-finite.

        A path's warm W0 = inv(T0) has its diagonal reset to S_ii + lam, but
        its off-diagonal entries are only dual-feasible for the previous,
        larger lambda; after a large drop in lambda the BCD iterate can
        leave the positive-definite cone and return NaN (the reference
        package does so too).  Such lanes are rare; they go down the
        repair path with their non-finite candidates, which selects the
        cold pair (W0 = S + lam*I), and are counted in
        ``router.fallback.warm``.  The warm stacks come to the host here
        once and assembly reuses the copies."""
        repairs = []
        for p in pending:
            if not p.warm:
                continue
            p.host = p.out.cpu().numpy()
            bad = ~np.isfinite(p.host).all(axis=(1, 2))
            if bad.any():
                idx = np.flatnonzero(bad)
                bump("router.fallback.warm", int(idx.size))
                repairs.append((p, self._dispatch_repair(p.bucket, idx, p.host[idx], lam,
                                                         p.device)))
        for p, (idx, fixed) in repairs:
            out = p.out.clone()
            out[torch.as_tensor(idx, device=out.device)] = fixed
            p.out = out
            p.host = out.cpu().numpy()
