"""KKT residuals of the ``pg`` and ``admm`` solvers at their stopping
tolerances on the chip check's main workload, for the port and for the JAX
reference; and their distance to the ``bcd`` solve.

    # the port (repro_torch) on the CPU, or on the card with --device cuda
    PYTHONPATH=src python scripts/solver_buckets.py --blocks 40 120
    # the same through the reference (repro, JAX on the CPU)
    PYTHONPATH=src python scripts/solver_buckets.py --blocks 40 120 --reference

Data: ``structured_synthetic(blocks, 24, seed=0)`` at lambda 0.6 (250 blocks
is the chip check's p = 6000 main case; 40 and 120 are p = 960 and 2880,
with the same generator's general and chordal blocks).  Each line gives the
solver, its ``tol``, the KKT residual of the whole Theta against the
check's bound 1e-5 max|S|, and max|Theta - Theta_bcd| relative to
max|Theta_bcd|.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LAM = 0.6


def _port(S, solver, tol, device):
    import torch

    from repro_torch import EngineOptions, glasso
    from repro_torch.core.solvers.kkt import kkt_residual

    opts = {} if tol is None else {"tol": tol}
    res = glasso(S, LAM, options=EngineOptions(solver=solver, solver_opts=opts, device=device))
    kkt = float(kkt_residual(torch.as_tensor(S), torch.as_tensor(res.Theta), LAM))
    return res, kkt


def _reference(S, solver, tol, _device):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.core import glasso
    from repro.core.solvers.kkt import kkt_residual
    from repro.engine import EngineOptions

    opts = {} if tol is None else {"tol": tol}
    res = glasso(S, LAM, options=EngineOptions(solver=solver, solver_opts=opts))
    kkt = float(kkt_residual(jnp.asarray(S), jnp.asarray(res.Theta), LAM))
    return res, kkt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[40, 120])
    ap.add_argument("--tols", type=float, nargs="+", default=[1e-7, 1e-9])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    solve = _reference if args.reference else _port
    from repro_torch.covariance import structured_synthetic

    for K in args.blocks:
        S = structured_synthetic(K, 24, seed=0)
        bound = 1e-5 * float(np.abs(S).max())
        bcd, kkt_bcd = solve(S, "bcd", None, args.device)
        scale = float(np.abs(bcd.Theta).max())
        print(f"blocks={K} p={S.shape[0]} route_mix={bcd.route_mix} bound={bound:.6g} "
              f"bcd_kkt={kkt_bcd:.6g}", flush=True)
        for solver in ("pg", "admm"):
            for tol in args.tols:
                res, kkt = solve(S, solver, tol, args.device)
                rel = float(np.abs(res.Theta - bcd.Theta).max()) / scale
                print(f"  {solver} tol={tol:g} kkt={kkt:.6g} within_bound={kkt <= bound} "
                      f"theta_vs_bcd_rel={rel:.3g}", flush=True)


if __name__ == "__main__":
    main()
