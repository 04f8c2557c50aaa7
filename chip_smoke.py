"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. build     compile the CUDA kernels from ``src/repro_torch/csrc`` and
             print the build seconds and the card's name and power limit;
2. tree      ``tree_glasso`` against its plain PyTorch version on float64
             stacks at b in {2, 8, 64, 384}, sized to fill the card;
3. bucket    ``bucket_glasso`` against its plain version, cold and warm
             lanes at b in {4, 16, 64, 128}: sweep counts equal lane by
             lane, Theta within tolerance, KKT residual <= 1e-5 max|S|;
4. main      ``repro_torch.glasso(S, lam)`` with default options on the
             card: a p = 6000 planted-structure covariance (pairs, trees,
             chordal and general blocks) and the paper's Table-1 shape
             ``paper_synthetic(K=5, p1=100)`` at lambda_I.  The launch
             counters are zeroed just before the p = 6000 solve and read
             just after; labels must equal scipy's connected components
             of |S| > lam, Theta must vanish across components, and the
             KKT residual of the full Theta (torch.linalg on the card) must
             be <= 1e-5 max|S|.  The p = 6000 solve runs twice (the
             first pays one-time library set-up).  Then each kernel is
             timed against its plain version on the inputs that solve gave
             it;
5. kernels   one JSON line: every ported kernel with its launches on the
             main path, error, times and bound;

and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits nonzero and prints no result; so does a machine without
CUDA.  Data is made from fixed seeds with numpy.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import EngineOptions, glasso  # noqa: E402
from repro_torch.core import instrument  # noqa: E402
from repro_torch.core.blocks import pad_block  # noqa: E402
from repro_torch.core.screening import thresholded_components  # noqa: E402
from repro_torch.core.solvers.bcd import convergence_scale  # noqa: E402
from repro_torch.core.solvers.kkt import kkt_residual  # noqa: E402
from repro_torch.covariance import (  # noqa: E402
    lambda_interval_for_k,
    paper_synthetic,
    structured_synthetic,
)
from repro_torch.engine.planner import build_plan_incremental  # noqa: E402
from repro_torch.engine.registry import route_for  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.bucket_glasso.ops import fused_bcd_stack  # noqa: E402
from repro_torch.kernels.bucket_glasso.ref import fused_bcd_ref_stack  # noqa: E402
from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack  # noqa: E402
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and the FP64
# tensor-core rate, the highest FP64 rate the card has
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 67e12

DEV = torch.device("cuda")
# max|Theta_kernel - Theta_plain| allowed, relative to max|Theta_plain|:
# both round every elementwise product the same way, but dot products and
# row sums add in another order (float64, eps 2.2e-16, sums of <= 384 terms)
TREE_RTOL = 1e-13
# the BCD iterates carry those sum-order differences through every sweep;
# both stop at the same sweep (checked), so they agree to the convergence
# tolerance tol*scale = 1e-6 * scale at worst and far better in practice
BUCKET_RTOL = 1e-9
KKT_RTOL = 1e-5


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def tree_bound_ms(B: int, b: int) -> float:
    return 2 * B * b * b * 8 / HBM_BYTES_PER_S * 1e3


def bucket_bound(N: int, b: int, sweeps: torch.Tensor, cd: torch.Tensor) -> tuple[float, float, int]:
    """(bytes ms, operations ms, longest serial chain) of one launch; its
    bound is the larger of the two times.

    Bytes: S, W0, T0 read and Theta written once.  Operations this run's
    data needs: 2 b^2 flops per inner coordinate-descent sweep (b coordinate
    updates, each a length-b dot product) and 2 b^2 per column matvec
    (b columns per outer sweep).  The serial chain of a lane is its count of
    coordinate updates, inner sweeps x b."""
    t_bytes = 4 * N * b * b * 8 / HBM_BYTES_PER_S * 1e3
    flops = 2.0 * b * b * float(cd.sum()) + 2.0 * b**3 * float(sweeps.sum())
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    chain = int(cd.max()) * b if cd.numel() else 0
    return t_bytes, t_ops, chain


# ------------------------------------------------------------------ phase 1


def phase_build() -> None:
    path, seconds, out = kbuild.build()
    if out:  # the compiler's full report, beside the library it built
        path.with_suffix(".log").write_text(out)
    kbuild.library()
    usage = [ln.strip() for ln in out.splitlines() if "registers" in ln]
    log("build", seconds=f"{seconds:.3f}", library=path.name, ptxas="; ".join(usage))
    log("card", nvidia_smi=json.dumps(card_line()), torch=torch.__version__,
        cuda=torch.version.cuda)


# ------------------------------------------------------------------ phase 2


def phase_tree() -> None:
    rng = np.random.default_rng(1)
    for b in (2, 8, 64, 384):
        B = max(1, (1 << 25) // (b * b))  # 256 MB of float64 per stack
        A = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(B, b, b)), device=DEV)
        S = 0.5 * (A + A.transpose(1, 2))
        S.diagonal(dim1=1, dim2=2).add_(float(b))
        lams = torch.as_tensor(rng.uniform(0.3, 0.9, size=B), device=DEV)
        del A
        got = glasso_forest_stack(S, lams)
        want = glasso_forest_ref(S, lams)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= TREE_RTOL * scale:
            raise AssertionError(f"tree_glasso b={b}: max|diff|={err} > {TREE_RTOL}*{scale}")
        ms = cuda_ms(lambda: glasso_forest_stack(S, lams), 10)
        plain = cuda_ms(lambda: glasso_forest_ref(S, lams), 3)
        log("tree", b=b, B=B, max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{tree_bound_ms(B, b):.4f}")
        del S, lams, got, want
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 3


def _general_lanes(rng, n: int, b: int) -> tuple[np.ndarray, float]:
    """n padded (b, b) lanes: chordless cycles on 3b/4 vertices plus random
    chords (a general structure, as the planner's iterative buckets hold),
    diagonally dominant, and the lambda that screens them."""
    lam = 0.3
    m = max(4, 3 * b // 4)
    out = []
    for _ in range(n):
        S = np.triu(rng.uniform(-0.8 * lam, 0.8 * lam, size=(m, m)), 1)
        edges = [(i, (i + 1) % m) for i in range(m)]
        edges += [tuple(rng.choice(m, size=2, replace=False)) for _ in range(m // 4)]
        for i, j in edges:
            S[min(i, j), max(i, j)] = rng.uniform(lam + 0.05, lam + 0.5) * rng.choice([-1.0, 1.0])
        S = S + S.T
        np.fill_diagonal(S, 1.0 + np.abs(S).sum(axis=1))
        out.append(pad_block(S, b))
    return np.stack(out), lam


def compare_bucket(S, lams, W0, T0, label: str, *, time_plain: bool = True) -> dict:
    """Kernel against plain version on one stack; raises on disagreement."""
    N, b, _ = S.shape
    scales = convergence_scale(S)
    cd = torch.empty(N, dtype=torch.int64, device=DEV)
    theta, sweeps = fused_bcd_stack(S, lams, scales, W0, T0, cd_sweeps=cd)
    cd_ref = torch.empty_like(cd)
    t0 = time.perf_counter()
    theta_ref, sweeps_ref = fused_bcd_ref_stack(S, lams, scales, W0, T0, cd_sweeps=cd_ref)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(sweeps, sweeps_ref):
        raise AssertionError(f"bucket_glasso {label}: sweeps {sweeps.tolist()} != {sweeps_ref.tolist()}")
    if not torch.equal(cd, cd_ref):
        raise AssertionError(f"bucket_glasso {label}: inner sweeps {cd.tolist()} != {cd_ref.tolist()}")
    err = float((theta - theta_ref).abs().max())
    scale = float(theta_ref.abs().max())
    if not err <= BUCKET_RTOL * scale:
        raise AssertionError(f"bucket_glasso {label}: max|diff|={err} > {BUCKET_RTOL}*{scale}")
    res = kkt_residual(S, theta, lams)
    smax = S.abs().amax(dim=(1, 2))
    if not bool((res <= KKT_RTOL * smax).all()):
        raise AssertionError(f"bucket_glasso {label}: KKT {res.tolist()} > {KKT_RTOL}*max|S|")
    ms = cuda_ms(lambda: fused_bcd_stack(S, lams, scales, W0, T0), 3)
    plain_ms = plain_s * 1e3
    if time_plain:
        plain_ms = cuda_ms(lambda: fused_bcd_ref_stack(S, lams, scales, W0, T0), 1)
    t_bytes, t_ops, chain = bucket_bound(N, b, sweeps, cd)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                bound_ms=max(t_bytes, t_ops), chain=chain, sweeps=sweeps,
                kkt=float(res.max()))


def phase_bucket() -> None:
    rng = np.random.default_rng(2)
    for b, n in ((4, 64), (16, 32), (64, 8), (128, 4)):
        blocks, lam = _general_lanes(rng, n, b)
        S = torch.as_tensor(blocks, device=DEV)
        lams = torch.full((n,), lam, dtype=torch.float64, device=DEV)
        eye = torch.eye(b, dtype=torch.float64, device=DEV)
        # cold lanes: W0 = S + lam I, T0 = I; warm lanes: the solution at a
        # 10% larger lambda, as a path or a repair would hand over
        W_cold = S + lams[:, None, None] * eye
        T_cold = eye.expand(n, b, b).contiguous()
        T_warm, _ = fused_bcd_stack(S, 1.1 * lams, convergence_scale(S), W_cold, T_cold)
        W_warm = torch.linalg.inv(T_warm)
        for kind, W0, T0 in (("cold", W_cold, T_cold), ("warm", W_warm, T_warm)):
            r = compare_bucket(S, lams, W0, T0, f"b={b} {kind}", time_plain=False)
            log("bucket", b=b, N=n, lanes=kind, sweeps=r["sweeps"].tolist()[:8],
                max_abs_err=r["err"], kkt_max=r["kkt"], ms=f"{r['ms']:.3f}",
                plain_ms=f"{r['plain_ms']:.3f}", bound_ms=f"{r['bound_ms']:.6f}",
                bytes_ms=f"{r['bytes_ms']:.6f}", ops_ms=f"{r['ops_ms']:.6f}",
                serial_steps=r["chain"])


# ------------------------------------------------------------------ phase 4


def check_solution(S: np.ndarray, lam: float, res) -> float:
    """Theorem-1 partition, cross-component zeros and KKT on the card;
    returns the KKT residual."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    A = np.abs(S) > lam
    np.fill_diagonal(A, False)
    _, comp = connected_components(csr_matrix(A), directed=False)
    # canonical: each component labelled by its smallest vertex
    first = np.full(comp.max() + 1, S.shape[0])
    np.minimum.at(first, comp, np.arange(S.shape[0]))
    if not np.array_equal(np.asarray(res.labels), first[comp]):
        raise AssertionError("labels differ from scipy's connected components")
    lab = np.asarray(res.labels)
    cross = lab[:, None] != lab[None, :]
    if np.any(res.Theta[cross] != 0.0):
        raise AssertionError("Theta is nonzero across components")
    kkt = float(kkt_residual(torch.as_tensor(S, device=DEV),
                             torch.as_tensor(res.Theta, device=DEV), lam))
    if not kkt <= KKT_RTOL * float(np.abs(S).max()):
        raise AssertionError(f"KKT residual {kkt} > {KKT_RTOL}*max|S|")
    if not np.isfinite(res.Theta).all():
        raise AssertionError("Theta has non-finite entries")
    return kkt


def solve_on_card(name: str, S: np.ndarray, lam: float) -> dict[str, int]:
    """One default-options solve on the card, checked; returns its kernel
    launches.  The first solve of the process also pays the CUDA libraries'
    one-time set-up (the batched inverse of the KKT check)."""
    torch.cuda.synchronize()
    instrument.reset("kernels.")
    t0 = time.perf_counter()
    res = glasso(S, lam, options=EngineOptions())
    wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    kkt = check_solution(S, lam, res)
    stages = res.stages()
    plan_s = res.trace.stage_seconds().get("engine.plan", 0.0) if res.trace else 0.0
    log("main", case=name, p=S.shape[0], lam=f"{lam:.6g}", device=res.device,
        route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), kkt=kkt,
        max_abs_S=float(np.abs(S).max()), wall_s=f"{wall:.3f}",
        screen_s=f"{stages['screen']:.4f}", plan_s=f"{plan_s:.4f}",
        solve_s=f"{stages['solve']:.4f}", dispatch_s=f"{stages['dispatch']:.4f}",
        assemble_s=f"{stages['assemble']:.4f}")
    return launches


def main_path_kernels(S: np.ndarray, lam: float) -> list[dict]:
    """Time each kernel against its plain version on the stacks the main
    path hands it (the same plan the solve built)."""
    labels, _ = thresholded_components(S, lam)
    plan = build_plan_incremental(S, lam, labels)
    tree = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0)
    bucket = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes_ms=0.0, ops_ms=0.0,
                  chain=0)
    for bk in plan.buckets:
        route = route_for(bk.structure)
        blocks = torch.as_tensor(bk.blocks, device=DEV)
        n, b = blocks.shape[0], blocks.shape[1]
        lams = torch.full((n,), lam, dtype=torch.float64, device=DEV)
        if route == "closed_form":
            got = glasso_forest_stack(blocks, lams)
            want = glasso_forest_ref(blocks, lams)
            err = float((got - want).abs().max())
            if not err <= TREE_RTOL * float(want.abs().max()):
                raise AssertionError(f"tree_glasso main path b={b}: max|diff|={err}")
            ms = cuda_ms(lambda: glasso_forest_stack(blocks, lams), 10)
            plain_ms = cuda_ms(lambda: glasso_forest_ref(blocks, lams), 3)
            log("main_tree", structure=bk.structure, b=b, N=n, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=tree_bound_ms(n, b))
            tree["err"] = max(tree["err"], err)
            tree["ms"] += ms
            tree["plain_ms"] += plain_ms
            tree["bound_ms"] += tree_bound_ms(n, b)
        elif route == "iterative":
            eye = torch.eye(b, dtype=torch.float64, device=DEV)
            r = compare_bucket(blocks, lams, blocks + lams[:, None, None] * eye,
                               eye.expand(n, b, b).contiguous(), f"main b={b}")
            log("main_bucket", b=b, N=n, sweeps=r["sweeps"].tolist(), max_abs_err=r["err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bytes_ms=r["bytes_ms"],
                ops_ms=r["ops_ms"], serial_steps=r["chain"])
            for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                bucket[k] += r[k]
            bucket["err"] = max(bucket["err"], r["err"])
            bucket["chain"] = max(bucket["chain"], r["chain"])
    return [tree, bucket]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    phase_tree()
    phase_bucket()

    S = structured_synthetic(250, 24, seed=0)
    lam = 0.6
    launches = solve_on_card("structured K=250 p1=24", S, lam)
    solve_on_card("structured K=250 p1=24 (repeat)", S, lam)
    for name in ("tree_glasso", "bucket_glasso"):
        if launches.get(f"{name}.launches", 0) <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    tree, bucket = main_path_kernels(S, lam)

    P = paper_synthetic(5, 100, seed=0)
    lo, hi = lambda_interval_for_k(P, 5)
    paper_launches = solve_on_card("paper_synthetic K=5 p1=100 lambda_I", P, 0.5 * (lo + hi))
    if paper_launches.get("bucket_glasso.launches", 0) <= 0:
        raise AssertionError("bucket_glasso was not launched on the Table-1 shape")

    log("main_kernels", tree_ms=tree["ms"], tree_plain_ms=tree["plain_ms"],
        tree_bound_ms=tree["bound_ms"], bucket_ms=bucket["ms"],
        bucket_plain_ms=bucket["plain_ms"], bucket_bytes_ms=bucket["bytes_ms"],
        bucket_ops_ms=bucket["ops_ms"], bucket_serial_steps=bucket["chain"])
    kernels = [
        {
            "name": "tree_glasso", "route": "cuda",
            "source": "src/repro_torch/csrc/tree_glasso.cu",
            "replaces": "src/repro/kernels/tree_glasso/tree_glasso.py:27",
            "launches": launches["tree_glasso.launches"],
            "max_abs_err": tree["err"], "ms": tree["ms"], "plain_ms": tree["plain_ms"],
            "bound_ms": tree["bound_ms"], "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "bucket_glasso", "route": "cuda",
            "source": "src/repro_torch/csrc/bucket_glasso.cu",
            "replaces": "src/repro/kernels/bucket_glasso/bucket_glasso.py:34",
            "launches": launches["bucket_glasso.launches"],
            "max_abs_err": bucket["err"], "ms": bucket["ms"], "plain_ms": bucket["plain_ms"],
            "bound_ms": bucket["bound_ms"],
            "bound_by": "operations" if bucket["ops_ms"] > bucket["bytes_ms"] else "bytes",
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
