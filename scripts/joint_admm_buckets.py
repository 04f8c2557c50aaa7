"""Iteration counts of the joint ADMM on the joint_general buckets of the
joint benchmark's workload, for the port and for the JAX reference.

    # the port (repro_torch), on the card and on the CPU; writes each
    # bucket's stack to OUT/bucket_<p>_<penalty>_<size>.npy
    PYTHONPATH=src python scripts/joint_admm_buckets.py --blocks 375 --penalty group \
        --max-iter 2000 20000 --out joint_buckets
    # the reference (repro, JAX on the CPU) on the stacks written above
    PYTHONPATH=src python scripts/joint_admm_buckets.py --reference joint_buckets

Data: ``structured_synthetic(blocks, 16, classes=4, shared_fraction=0.85,
seed=1)`` at lam1 = 0.4, lam2 = 0.1, tol 1e-9 (``benchmarks/bench_joint.py``'s
generator and settings; 375 blocks is p = 6000, 150 is bench_joint's own
p = 2400).  Each line gives the bucket, the device, the iteration budget,
the min / median / max iterations over its lanes and the worst block's
joint KKT residual against max|S|.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LAM1, LAM2, TOL = 0.4, 0.1, 1e-9


def _stats(it) -> str:
    it = np.asarray(it)
    return f"{int(it.min())} {int(np.median(it))} {int(it.max())}"


def port(blocks: int, penalty: str, budgets: list[int], devices: list[str], out: Path) -> None:
    import torch

    from repro_torch import EngineOptions
    from repro_torch.covariance import structured_synthetic
    from repro_torch.joint import JointEngine, joint_admm_info, joint_kkt_residual

    Ss = list(structured_synthetic(blocks, 16, classes=4, shared_fraction=0.85, seed=1))
    eng = JointEngine(options=EngineOptions(device="cpu"))
    labels, _ = eng.screen(Ss, LAM1, LAM2, penalty=penalty)
    plan = eng.plan(Ss, LAM1, LAM2, labels, penalty=penalty)
    out.mkdir(parents=True, exist_ok=True)
    for bk in plan.buckets:
        if bk.structure != "joint_general":
            continue
        S = np.asarray(bk.blocks)
        name = f"bucket_{blocks * 16}_{penalty}_{bk.size}"
        np.save(out / f"{name}.npy", S)
        for dev in devices:
            for budget in budgets:
                t0 = time.perf_counter()
                th, it = joint_admm_info(torch.as_tensor(S, device=dev), LAM1, LAM2,
                                         penalty=penalty, tol=TOL, max_iter=budget)
                th = th.cpu().numpy()
                seconds = time.perf_counter() - t0
                kkt = max(
                    joint_kkt_residual(S[i][:, :len(c), :len(c)], th[i][:, :len(c), :len(c)],
                                       LAM1, LAM2, penalty=penalty)
                    for i, c in enumerate(bk.comps)
                )
                print(f"port {name} lanes={len(bk.comps)} device={dev} max_iter={budget} "
                      f"iters={_stats(it.cpu())} kkt={kkt} max_abs_S={np.abs(S).max()} "
                      f"seconds={seconds:.3f}", flush=True)


def reference(directory: Path, budget: int) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.joint import joint_admm_info

    for path in sorted(directory.glob("bucket_*.npy")):
        penalty = path.stem.split("_")[2]
        S = jnp.asarray(np.load(path))
        _, it = jax.vmap(
            lambda s: joint_admm_info(s, LAM1, LAM2, penalty=penalty, tol=TOL, max_iter=budget)
        )(S)
        print(f"reference {path.stem} max_iter={budget} iters={_stats(it)}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=375)
    ap.add_argument("--penalty", choices=("group", "fused"), default="group")
    ap.add_argument("--max-iter", type=int, nargs="+", default=[2000])
    ap.add_argument("--device", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--out", type=Path, default=Path("joint_buckets"))
    ap.add_argument("--reference", type=Path, default=None,
                    help="run the JAX reference on the bucket stacks in this directory")
    args = ap.parse_args()
    if args.reference is not None:
        reference(args.reference, args.max_iter[0])
    else:
        port(args.blocks, args.penalty, args.max_iter, args.device, args.out)


if __name__ == "__main__":
    main()
