"""Timings that size the chip check's [oversize] phase, on the card.

    PYTHONPATH=src python scripts/giant_block_probe.py

Builds the CUDA kernels (printing the ptxas lines of the ``prox_l1`` and
``shard_prox`` kernels), times one float64 ``torch.linalg.eigh`` and one
float64 product at n = 1280 and 2560, 40 iterations of the dense ``admm``
solver on the giant block of ``benchmarks/bench_giant.py``'s workload at
p = 1280 and 2560 (lambda 0.12), and the whole sharded and dense solves of
the p = 1280 giant block (b = 1273): outer and inner iterations, the
in-place KKT residual, and the two solutions' largest difference.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import chip_smoke as cs
    from repro_torch.core.components import component_lists, components_from_covariance_host
    from repro_torch.core.solvers import glasso_admm_info, glasso_sharded
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    _, secs, out = kbuild.build()
    kbuild.library()
    print("build", secs, [ln for ln in out.splitlines()
                          if "prox_l1" in ln or "shard_prox" in ln or "registers" in ln])
    print(cs.card_line(), flush=True)
    for n in (1280, 2560):
        A = torch.randn(n, n, dtype=torch.float64, device="cuda")
        A = A + A.T
        torch.linalg.eigh(A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            torch.linalg.eigh(A)
        torch.cuda.synchronize()
        print("n", n, "eigh_s", (time.perf_counter() - t0) / 3,
              "matmul_ms", cs.cuda_ms(lambda: A @ A, 10), flush=True)
    lam = torch.tensor([cs.GIANT_LAM], dtype=torch.float64, device="cuda")
    for p in (1280, 2560):
        S = cs.giant_workload(p)
        comp = max(component_lists(components_from_covariance_host(S, cs.GIANT_LAM)), key=len)
        blk = S[np.ix_(comp, comp)]
        blk_dev = torch.as_tensor(blk, device="cuda")[None]
        t0 = time.perf_counter()
        glasso_admm_info(blk_dev, lam, tol=1e-9, max_iter=40)
        torch.cuda.synchronize()
        print("p", p, "b", len(comp), "dense admm 40 it s", time.perf_counter() - t0, flush=True)
        if p != 1280:
            continue
        t0 = time.perf_counter()
        r = glasso_sharded(blk, cs.GIANT_LAM, kkt_target=1e-6)
        print("sharded", p, "s", time.perf_counter() - t0, "iters", r.iters, "inner",
              r.inner_iters, "retries", r.retries, "kkt", r.kkt_residual, "rho", r.rho,
              flush=True)
        t0 = time.perf_counter()
        T, it = glasso_admm_info(blk_dev, lam, tol=1e-9)
        torch.cuda.synchronize()
        print("dense", p, "s", time.perf_counter() - t0, "iters", int(it[0]), "diff",
              float(np.abs(T[0].cpu().numpy() - r.Theta).max()), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("giant_block_probe: needs a CUDA card")
    main()
