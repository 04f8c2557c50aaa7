"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. build     compile the CUDA kernels from ``src/repro_torch/csrc`` and
             print the build seconds and the card's name and power limit;
             [bucket_instances] and [covgram_instances] each instance's
             registers, stack and spill bytes from ptxas;
             [flash_instances] each flash_attention instance's registers,
             local (spilled and stack) bytes, shared bytes and blocks an SM;
1b. flash_attention  the kernel against its plain version at the
             prefill's shape in float32 and bf16, a ragged length and full
             MHA in both, MQA, a long causal case (against the plain
             chunked form), Phi-3-mini's d = 96 (its own instance), head
             dims 192 (DeepSeek-V2-Lite's query-key width) and 256, and
             320 and 512 (each body's wide instance), timed
             beside its bound, the plain version and SDPA, with the
             profiler's device time of each case (run first, while the
             profiler is fresh: after sessions of thousands of events it
             records short ones only in part); each case must run its
             dtype's body (fp32 or wgmma);
2. tree      ``tree_glasso`` against its plain PyTorch version on float64
             stacks at b in {2, 8, 64, 384}, sized to fill the card;
3. bucket    ``bucket_glasso`` against its plain version, cold and warm
             lanes at b in {4, 16, 64, 128}: sweep counts equal lane by
             lane, Theta within tolerance, KKT residual <= 1e-5 max|S|;
             ``ns_per_step``, the kernel's time over the longest lane's
             serial coordinate updates;
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
             it ([main_tree] with each stack's Theta sha256, device ms and
             host ms a call, [main_bucket], [main_kernels] with
             ``ns_per_step``); ``phase_main_kernels`` does the same alone,
             with the [pg] solve's prox_l1 launches, for
             ``scripts/compare_turns.py``;
5. threshold_cc  the hook step against its plain version on
             ``structured_synthetic`` at p = 6000 and p = 20016 (lam = 0.6):
             ms per step, the bound, the rounds to the fixed point, the
             host-to-device copy of S, and labels equal to the host
             union-find;
6. screen    the dense main path with ``cc_backend="pallas"`` (the device
             screen) at p = 6000: labels and route mix equal to the host
             screen's run, the same checks as phase 4, launch counters
             zeroed just before and read just after; every hook step of
             the first solve is recorded, then held against its plain
             version and timed on its own inputs;
1c. card_tests  the card tests of flash_attention, covgram_screen,
             joint_prox, bucket_glasso, prox_l1, covgram and tree_glasso,
             of the scratch-keeping wrappers under two threads and of
             concurrent ``GlassoServer`` submissions
             (``tests/test_torch_cuda_kernels.py -k CARD_TESTS``) in
             subprocesses;
7. covgram_screen  the fused Gram + threshold kernel against its plain
             version at n = 192, tile 512 and tile 2048, on the tile pairs
             the two data paths below schedule: CUDA-event and profiler
             device ms (the tile indices on the card, as the paths pass
             them; ``ms_host_indices`` with numpy ones), the share of the
             bound and one device event a call; then the float32 body on
             float32 copies of the tile-2048 batch, within 1e-5 max|S| of
             its plain version, its edges equal but for entries that near
             lam (counted), beside the float32 library product;
8. from_data ``glasso(X=X, lam=0.40, from_data=True)`` at p = 8000 (the
             benchmarks' dense-from-data arm): labels equal to the host
             union-find on the card's dense ``sample_covariance(X)``,
             cross-component zeros, KKT, and the margin min ||S_ij| - lam|
             that shows the kernel's sum order cannot flip an edge; every
             covgram_screen launch of the first solve is recorded, then
             held against its plain version and timed on its own inputs
             (device ms and the share of the bound too);
9. stream    ``stream_screen`` over an 8-lambda grid at p = 16000: every
             partition equal to the dense one;
10. joint    ``joint_glasso`` (group penalty) on the card at p = 6000,
             K = 4 (``benchmarks/bench_joint.py``'s generator, 85 % of the
             planted blocks shared, lam1 = 0.4, lam2 = 0.1, tol 1e-9,
             an ADMM budget of 20000 iterations),
             one solve: labels equal to scipy's components of the
             hybrid rule computed here on the card, all five route classes,
             zero fallbacks, Theta zero across components in every class,
             the joint KKT residual of every block <= 1e-5 max|S|; the
             stages, the ADMM iteration counts per bucket and the split of
             one ADMM iteration (eigh, reconstruction, joint_prox, lanes);
11. joint_fused  the same with the fused penalty at bench_joint's p = 2400;
12. joint_from_data  ``joint_glasso(Xs=...)`` for K = 3 classes of the
             from-data workload at p = 8000 (tile 2048): streamed labels
             equal to the port's dense joint screen of each class's
             ``sample_covariance``, zero fallbacks, zeros, KKT, the
             candidate pairs and the tiles skipped;
13. joint_prox  the first, a middle and the last joint_prox launch of the
             [joint] and [joint_fused] solves, each held against its plain
             version on its own inputs (rp2/rd2 also against a second call,
             bit for bit) and timed, times summed over the three; the host
             ms to issue a call, and the profiler's device events of one
             call, which must be the one joint_prox kernel and nothing
             else;
14. pg, admm ``glasso(S, lam, solver="pg" | "admm")`` on the p = 6000 case
             of phase 4 (tol 1e-9), first and repeat: the checks of phase
             4, every rung of the route mix, Theta against phase 4's bcd
             solve, and the prox_l1 / shard_prox launches;
15. prox_l1  the first, a middle and the last prox_l1 launch of the [pg]
             solve, held against the plain version (bit-equal) and timed
             beside softshrink(theta - t*grad, t*lam); the host ms to issue
             a call and the profiler's device events of one call, which
             must be the one prox_l1 kernel and nothing else;
16. oversize ``glasso(S, lam, solver="admm", oversize_threshold=1024)`` on
             ``benchmarks/bench_giant.py``'s workload at p = 1280 (one
             component of 1273): one sharded dispatch, no fallback, the
             in-place KKT within route_check_tol * max(1, max|S|), Theta
             against the dense single-device admm solve of the same S
             (tol 1e-11); the
             outer and inner iterations, rho, the memory, and the split of
             one outer iteration;
             [oversize_budget] logs the budget that
             oversize_budget_mb="auto" reads, the threshold it derives, and
             the dense admm solve's measured peak bytes per padded entry
             beside the model's SINGLE_DEVICE_BUFFERS * 8 (whether the
             solve fits the budget at that threshold) and the solve's
             floor (four buffers plus eigh's own workspace, measured
             alone), which the peak must not exceed;
             the [pg], [admm], [oversize] and joint paths' checked launches
             also run through the kernels' float32 instances (float32
             copies of the same inputs, held to the float32 plain versions)
             and are timed (ms_f32);
16b. multidevice  the paper pillar over a mesh of 4 devices, here
             [cuda:0] * 4 (every shard's launches and every copy between
             shards on the one card): [large_scale]'s R screened through
             "shard_map" (labels equal to "pallas"', 4 row-slab
             threshold_cc launches a round, one slab past row 0 held to
             its plain version and timed beside its bound, ms against the
             one-device screen); [oversize]'s giant block at d = 4 and at
             d = 1, 50 outer iterations each from the same cold start
             (padded to sharded_pad_size(b, 4), the d = 4 iterate within
             1e-6 max|Theta| of the d = 1 one, 4 shard_prox launches an
             outer iteration; a depth cut of the solve to convergence);
             [main]'s p = 6000 solve through Engine(devices=[cuda:0] * 4), Theta bit-equal
             to the one-device solve, its buckets placed on all 4 indices;
17. shard_prox  the first, a middle and the last shard_prox launch of the
             [admm] and [oversize] solves, held against the plain version
             (rp2/rd2 also against a second call, bit for bit) and timed;
             the profiler's device events of one call, which must be the
             one shard_prox kernel and nothing else;
18. from_data_sparse  ``glasso(X=X, lam=0.30)`` with default options at
             bench_stream's p = 16000 workload: a SparseTheta whose
             partition equals the dense screen's on the card, its sparse
             KKT and stage split;
19. covgram  the covgram kernel against its plain version at the
             pipeline's shape (n = 80, p = 16000, float32), on bf16 input
             and at a ragged shape, timed beside its bound, the plain
             version and torch.matmul of the centered X, with the
             profiler's device ms and the host ms of a call, and S's
             sha256 (``scripts/compare_turns.py`` holds two checkouts'
             digests side by side);
20. large_scale  examples/large_scale_glasso.py's pipeline through the port
             at n = 80, p = 16000: covgram, the correlation R in float64,
             the capacity lambda for p_max = 64, the device screen held
             to the host
             screen, Engine(solver="bcd", tol=1e-7).run(R, lam, p_max=64,
             labels=...) with default options returning a SparseTheta, the
             blockwise KKT of the five largest components and of all;
21. f32      the phase-4 workload at dtype="float32" with bcd, pg and admm:
             Theta against the float64 solve, every float32 kernel
             instance's recorded launches against its float32 plain
             version;
22. joint_prox k20  joint_prox at K = 20 classes (the shared-memory shape),
             float64 and float32, against its plain version;
23. serve    the LM serving path, ``repro_torch.launch.serve.run_serving``
             on qwen2.5-3b at full width (float32, batch 4, a 2048-token
             prompt, 16 new tokens, seed 0): the parameter count, one
             flash_attention launch a layer in the prefill (counters zeroed
             just before the run, read just after), init / prefill / decode
             times, tokens/s and peak memory; the kernel's prefill logits
             against the dense path's on the card, and two decode steps
             against fresh prefills of the extended prompt; the kernel's
             device ms a prefill and its share of the prefill;
             [serve_profile] the device-busy share of one decode step;
24. prefill_bf16  qwen2.5-3b at full width in its config's own bfloat16
             (random weights from seed 0), ``Model.prefill`` of a batch of
             4 prompts of 2048 tokens: 36 launches of flash_attention's
             wgmma body a prefill (counters zeroed just before, read just
             after), the prefill's time, the kernel's device share of it,
             the dense path's prefill time and peak bytes, and the logits
             against the dense path's on the card (argmax agreement too);
24b. train   LM training, ``repro_torch.launch.train.run_training`` on
             qwen2.5-3b at full width and depth (float32, AdamW, remat
             "none", as its CLI runs it), 6 steps of 2 x 512 tokens: the
             parameter count, the loss and seconds of each step, tokens/s,
             peak memory and the model-FLOPs share against the FP32 peak;
             no ported kernel launched (counters zeroed just before, read
             just after); every loss finite, the last below the first.
             [train_oracle] a 2-layer cut of the same widths (full vocab)
             takes one train step in float32 and in float64 on the card,
             the float32 gradients within 1e-4 of the float64 global norm;
             [train_card_cpu] the reduced config's 12 steps on the card
             against the CPU; [train_restart] its bit-exact restart on the
             card (12 steps against 6, a checkpoint, a resume and 6) under
             torch.use_deterministic_algorithms;
25. path     ``glasso_path`` on ``benchmarks/bench_select.py``'s workload
             at its own size (p = 2400, 20 lambdas from 0.75 to 0.32,
             output "sparse", tol 1e-7): the warm path, the cold-restart
             loop (one ``glasso`` a lambda) and ``warm_start=False``, their
             walls; every step's labels equal to the host screen's, its
             KKT <= 1e-5 max|S|, warm within 1e-5 of cold block by block,
             the warm fraction >= 0.5 (bench_select's gates), one union-find
             pass; bucket_glasso and tree_glasso launches a step for the
             path and the cold loop ([path_launches], counters zeroed just
             before the path);
26. path_kernels  every bucket_glasso launch of that path, warm (W0, T0)
             lanes included, against the plain version on CPU copies (a
             process pool): sweeps equal lane by lane, Theta within
             BUCKET_RTOL; every tree_glasso launch likewise; all replayed
             and timed (CUDA-event and device ms);
26b. fused  the wave packer (``EngineOptions(fused=True)``) against the
             unfused dispatch on three workloads: a planted case of
             chordless cycles of sizes 4..63 (every bin, every b mod 4 up to
             32) at an exact tie lam, [main]'s p = 6000 host-screen solve and
             [path]'s grid; labels, Theta (block by block on the path) and
             every lane's sweeps equal bit for bit at every step,
             ``solver.fused.dispatches`` equal to the occupied bins a step,
             fewer bucket_glasso launches (at most as many on [main]), both
             walls and both dispatch-stage seconds; [fused_plain] every
             packed launch of the planted case against the plain version on
             CPU copies, sweeps equal lane by lane;
27. path_from_data  ``glasso_path(X=..., from_data=True)`` on [from_data]'s
             workload over 6 lambdas from 0.40 to 0.30: one streamed
             screen for the grid, every partition equal to the card's dense
             one, KKT at every step, the largest component a step;
28. path_oversize  [oversize]'s workload at GIANT_LAM and a lambda just
             below it that crosses no |S_ij|: one dispatch a step, no
             fallback, KKT, the giant bucket reused and its second sharded
             solve warm, with fewer outer iterations;
29. select   ``select_path`` with EBIC on [path]'s workload (the selected
             index is the argmin of ``ebic_score`` over [path]'s results),
             k-fold CV (k = 3) and StARS (4 subsamples) from
             [path_from_data]'s X and grid: selected lambda, warm fraction,
             walls;
30. serve_glasso  one ``GlassoServer`` with default engine options on
             the card, 12 requests submitted from four threads at once:
             8 ``DenseSpec`` ([main]'s S at lam 0.58 .. 0.65, and lam 0.6
             on seeds 1-4), 2 ``DataSpec`` ([from_data]'s X at lam 0.40,
             one under a session, then ``append_rows`` of 16 rows), 1
             ``PathSpec`` ([path]'s workload, EBIC) and 1 ``JointSpec``
             ([joint_from_data]'s Xs); each result held to its direct solve
             on the card (labels, route mix, Theta within 1e-9 max|Theta|
             and its digest, KKT), the served selection to ``select_path``
             bit for bit; walls by kind, the latency histogram's p50/p99,
             the serve.* counters, and the launches of one coalesced batch
             of the 8 dense requests (``solve_batch``) against the sum of
             their direct solves';
31. kernels  one JSON line: every ported kernel with its launches on its
             path and, summed over its recorded launches, its error, times
             and bound (with the lambda path's launches under "path");

and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits nonzero and prints no result; so does a machine without
CUDA.  Data is made from fixed seeds with numpy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path

import numpy as np

# [train]'s restart check runs under torch.use_deterministic_algorithms, which
# wants cuBLAS's workspace fixed before the first handle is made; 4096 KiB x 8
# is the default size on sm_90, so no other phase's products change
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import Engine, EngineOptions, glasso, glasso_path  # noqa: E402
from repro_torch.core import instrument  # noqa: E402
from repro_torch.core.blocks import (  # noqa: E402
    SINGLE_DEVICE_BUFFERS,
    oversize_threshold,
    pad_block,
)
from repro_torch.core.components import (  # noqa: E402
    component_lists,
    components_from_covariance_host,
    partitions_equal,
)
from repro_torch.core.distributed import device_memory_budget_mb  # noqa: E402
from repro_torch.core.solvers.sharded import glasso_sharded, sharded_pad_size  # noqa: E402
from repro_torch.engine.executor import BucketExecutor  # noqa: E402
from repro_torch.core.partition import lambda_for_max_component  # noqa: E402
from repro_torch.core.screening import count_edges, thresholded_components  # noqa: E402
from repro_torch.core.solvers.bcd import convergence_scale  # noqa: E402
from repro_torch.core.solvers.closed_form import kkt_residual_host  # noqa: E402
from repro_torch.core.solvers.kkt import kkt_residual, kkt_residual_sparse  # noqa: E402
from repro_torch.core.sparse import SparseTheta  # noqa: E402
from repro_torch.covariance import (  # noqa: E402
    lambda_interval_for_k,
    microarray_like,
    paper_synthetic,
    sample_covariance,
    structured_synthetic,
)
from repro_torch.engine.planner import build_plan_incremental  # noqa: E402
from repro_torch.engine.registry import route_for  # noqa: E402
from repro_torch.engine.waves import FUSED_BINS, fused_bin  # noqa: E402
from repro_torch.joint import joint_glasso  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.bucket_glasso.ops import fused_bcd_stack  # noqa: E402
from repro_torch.kernels.bucket_glasso.ref import fused_bcd_ref_stack  # noqa: E402
from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack  # noqa: E402
from repro_torch.kernels.covgram_screen import (  # noqa: E402
    covgram_screen_ref,
    covgram_screen_tiles,
    pad_for_screen,
)
from repro_torch.kernels.covgram_screen.ops import MMA  # noqa: E402
from repro_torch.kernels.threshold_cc import (  # noqa: E402
    connected_components_kernel,
    labelprop_rows,
    labelprop_rows_ref,
    labelprop_step,
    labelprop_step_ref,
)
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref  # noqa: E402
from repro_torch.obs.device_profile import profile_calls  # noqa: E402
from repro_torch.select import CovSource, ebic_score, select_path  # noqa: E402
from repro_torch.stream import stream_screen  # noqa: E402
from repro_torch.stream.tiler import (  # noqa: E402
    column_moments,
    tile_maxima,
    tile_pair_schedule,
)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, the FP64
# tensor-core rate (the highest FP64 rate the card has), the FP32 rate
# outside the tensor cores (covgram's and float32 attention's FMAs) and the
# dense bf16 tensor-core rate (bf16 attention's bound)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 67e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores
EPS32 = float(torch.finfo(torch.float32).eps)

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
# covgram_screen sums the same float64 products as its plain version in
# another order (FMA, 32-row slabs): entries of O(1) agree to ~1e-15; the
# check allows 1e-12 of the largest |S_ij|, and counts must be equal
COVGRAM_RTOL = 1e-12
# covgram_screen's float32 body against its plain version at float32 (the
# two sum in different orders): vals and stats within 1e-5 max|S|
COVGRAM_F32_RTOL = 1e-5
# the from-data and stream phases fail loudly when an |S_ij| lies closer to
# a lambda than this (relative to max|S|): the sum order could flip it
MARGIN_RTOL = 1e-12

# sizes of the main-path phases (full size; a CPU rehearsal shrinks them)
MAIN_CASE = (250, 24)    # structured_synthetic (K, p1): p = 6000
PAPER_CASE = (5, 100)    # paper_synthetic (K, p1): the Table-1 shape
THRESHOLD_CC_CASES = ((250, 24), (834, 24))  # structured_synthetic (K, p1)
SCREEN_LAM = 0.6
N_ROWS = 192
FROM_DATA_P, FROM_DATA_LAM, FROM_DATA_TILE = 8000, 0.40, 2048
STREAM_P, STREAM_TILE = 16000, 512
STREAM_GRID = (0.30, 0.26, 0.22, 0.18, 0.14, 0.10, 0.075, 0.05)  # descending
CHUNK = 64
PAIR_BATCH = 64  # StreamConfig's default: tile pairs in flight per launch
# the joint K-class phases: benchmarks/bench_joint.py's generator and
# settings, structured_synthetic(K_blocks, p1, classes=, shared_fraction=,
# seed=1) at lam1 = 0.4, lam2 = 0.1
JOINT_CASE = (375, 16, 4, 0.85)        # p = 6000, K = 4: the main path's size
JOINT_FUSED_CASE = (150, 16, 4, 0.85)  # p = 2400: bench_joint's own size
JOINT_LAM1, JOINT_LAM2 = 0.4, 0.1
# bench_joint's tol; the ADMM budget raised from the default 2000: at
# p = 6000 the group penalty's b = 16 lanes need up to ~5100 iterations to
# stop (the reference's ADMM stops at the same counts: ROADMAP queue 3)
JOINT_SOLVER_OPTS = {"tol": 1e-9, "max_iter": 20000}
JOINT_FROM_DATA_K = 3
JOINT_ROUTES = ("singleton", "joint_forest", "joint_chordal", "joint_shared", "joint_general")
# the fused rule screens no chordal shared component on its workload
JOINT_FUSED_ROUTES = ("singleton", "joint_forest", "joint_shared", "joint_general")
# joint_prox repeats the plain version's per-entry arithmetic; the class and
# lane sums of rp2/rd2 run in another order (float64, sums of K b^2 terms)
JOINT_PROX_ATOL = 1e-12
JOINT_PROX_RTOL = 1e-9
# [pg] / [admm]: the main path with the other block solvers, their stopping
# tolerance tightened from the reference's default 1e-7 to 1e-9 (the joint
# phases' and benchmarks' tol): at 1e-7, an absolute bound on the iterate,
# both stop above the KKT bound 1e-5 max|S| on this workload's badly scaled
# blocks (S_ii ~ 100), the reference exactly as the port
# (scripts/solver_buckets.py; ROADMAP queue 3)
SOLVER_OPTS = {"tol": 1e-9}
SOLVER_KERNELS = {
    "pg": ("repro_torch.core.solvers.pg", "prox_step", "prox_l1"),
    "admm": ("repro_torch.core.solvers.admm", "fused_prox_residual", "shard_prox"),
}
MAIN_ROUTES = ("singleton", "pair", "tree", "chordal", "general")
# Theta of pg / admm against the bcd solve of the same run, relative to
# max|Theta|: all three are KKT-optimal to 1e-5 max|S|; on the CPU at
# K = 40 and 120 the three agree to ~1e-6 (scripts/solver_buckets.py)
THETA_VS_BCD_RTOL = 1e-4
# shard_prox sums the same rounded squares as its plain version in another
# order (float64, up to bp^2 terms of the giant block)
SHARD_PROX_RTOL = 1e-14
# [oversize]: benchmarks/bench_giant.py's workload (its generator, n = 320)
# at its lambda, one giant component past the threshold, and bench_giant's
# acceptance at the engine's default route_check_tol.  p = 1280 (b = 1273),
# cut from 2560 (b = 2559): there the sharded solve alone took 99 s on the
# H100 (2215 outer iterations) and the phase ran past 150 s (PERF.md)
GIANT_P, GIANT_N, GIANT_LAM = 1280, 320, 0.12
GIANT_THRESHOLD = 1024
ROUTE_CHECK_TOL = 1e-6
# the dense single-device admm oracle of [oversize]: its stopping rule
# eps = tol * b is absolute, so at bench_giant's tol 1e-9 the b = 2559
# oracle stopped with a KKT residual of 1.9e-4 > 1e-5 max|S|; 1e-11 holds
# it to the same KKT check as every solve here
ORACLE_OPTS = {"tol": 1e-11, "max_iter": 20000}
# [covgram] / [large_scale]: examples/large_scale_glasso.py's pipeline at the
# example's n = 80 and bench_stream's largest p = 16000 (the example runs
# p = 1200), microarray_like(seed=7), p_max = 64, bcd at tol 1e-7, and the
# example's KKT bound on the blockwise residuals.  covgram's tolerance
# against its plain version is n float32 epsilons of max|S| (both sum n
# float32 products, in another order); the ragged case is not a multiple of
# the 128 x 128 tile, the 40-row chunk or 4 (the plain-store epilogue)
LARGE_N, LARGE_P, LARGE_SEED, LARGE_P_MAX = 80, 16000, 7, 64
LARGE_TOL, LARGE_KKT = 1e-7, 1e-4
COVGRAM_CASES = (("pipeline", 80, 16000, torch.float32),
                 ("bf16", 80, 16000, torch.bfloat16),
                 ("ragged", 77, 1001, torch.float32))
# [from_data_sparse]: bench_stream's p = 16000 workload at its grid's first
# lambda, default options (output "auto": sparse above p = 8192)
FROM_DATA_SPARSE_LAM = 0.30
# [f32]: the [main] workload at dtype="float32".  Theta against the float64
# bcd solve, relative to max|Theta|, about twice what the reference package's
# own float32 solve gives on the CPU: bcd 1e-5 (the float32 sweeps; the
# port 2.8e-7 on the CPU), pg 1e-2 (its line search decides float32 ties:
# the reference 5.0e-3, the port 5.3e-4), admm 5e-2 (float32 ADMM on blocks
# with S_ii up to 831 stops on its absolute rule ~2 % of max|Theta| away:
# the reference 2.3e-2, the port 1.95e-2).  Their default tol 1e-7: the
# 1e-9 of [pg]/[admm] lies below float32's resolution of the iterates.  The float32
# kernel instances against their float32 plain versions: tree_glasso 6e-5
# and bucket_glasso 1e-5 relative, prox_l1 and shard_prox's Z'/U' bit-equal,
# shard_prox's and joint_prox's sums 1e-5 relative, joint_prox's Z/U 1e-5
# absolute (tests/test_torch_cuda_kernels.py says why)
F32_THETA_RTOL = {"bcd": 1e-5, "pg": 1e-2, "admm": 5e-2}
F32_TREE_RTOL, F32_BUCKET_RTOL = 6e-5, 1e-5
F32_SUM_RTOL, F32_JOINT_ATOL = 1e-5, 1e-5
# joint_prox above 16 classes (the shared-memory shape): (n, K, b)
JOINT_PROX_K20 = (56, 20, 16)
# [serve]: the LM serving path (repro_torch.launch.serve's run_serving) at
# the full width of qwen2.5-3b (src/repro_torch/configs/qwen2_5_3b.py: 36
# layers, d_model 2048, 16 query heads over 2 KV heads of 128, d_ff 11008,
# QKV bias, vocab 151936 padded to 152064), float32 as the reference's
# serving entry point forces, random parameters from seed 0, batch 4, a
# 2048-token prompt and 16 new tokens.  SERVE_PARAMS is the reference's
# count_params_abstract of that config
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "qwen2_5_3b", 4, 2048, 16
SERVE_PARAMS = 3_397_627_904
# the serving checks' logits (the kernel's prefill against the dense path's
# on the card; each decode step against a fresh prefill of the extended
# prompt), within this share of max|logits|: every product is float32 (TF32
# off), and the paths differ only in sum order — the attention's, ~1e-6 of
# its outputs, carried through 36 layers
SERVE_LOGITS_RTOL = 1e-3
# [prefill_bf16]: the same model at its config's own bfloat16, one prefill
# of SERVE_BATCH prompts of SERVE_PROMPT tokens.  Its logits against the
# dense path's (use_flash=False) on the card, within this share of
# max|logits|: both paths round to bf16 after every layer's products and
# norms, and differ only in the attention's output (the kernel rounds p to
# bf16 before p v and sums in another order: ~1 bf16 ulp of the output,
# 2^-8 relative), which the residual stream carries through 36 layers
PREFILL_BF16_RTOL = 5e-2
# [train]: repro_torch.launch.train.run_training at the full width and depth
# of qwen2.5-3b (the [serve] config, 36 layers), float32 and AdamW with
# remat "none" as its CLI runs it, TRAIN_STEPS steps of batch TRAIN_BATCH x
# TRAIN_SEQ tokens (no cut of batch or sequence: the peak stays well under
# the card's memory).  The model-FLOPs share counts 6 * N * tokens against
# FP32_PEAK_FLOPS (TF32 off, as main() sets it)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 2, 512
FP32_PEAK_FLOPS = 67e12
# the full-width oracle: a TRAIN_ORACLE_LAYERS-layer cut of the same widths and
# the full vocab takes one train step in float32 and in float64 on the card,
# the float32 gradients within this share of the float64 global norm
TRAIN_ORACLE_LAYERS = 2
TRAIN_ORACLE_RTOL = 1e-4
# the reduced config's 12 steps on the card against the same on the CPU: the
# losses within the CPU tests' 1e-5 relative against the reference
# (tests/test_torch_train.py).  The card's products sum in other orders than
# the CPU's, and a parameter whose gradient nearly cancels can take Adam's
# step (up to lr_t <= 3e-4) the other way: the final state within 1e-4
# absolute, a third of one such step (measured 1.28e-5 on an H100)
TRAIN_CARD_CPU_RTOL = 1e-5
TRAIN_CARD_CPU_ATOL = 1e-4
# [serve_moe]: the MoE family with MLA, deepseek-v2-lite-16b
# (src/repro_torch/configs/deepseek_v2_lite_16b.py: 27 layers, d_model 2048,
# 16 MLA heads with a 512-wide latent, q/k 128 + 64 rope, v 128; 2 shared and
# 64 routed experts of 1408, top 6; vocab 102400) at full width and depth
# through run_serving, float32, random parameters from seed 0, [serve]'s
# batch, prompt and new tokens, its checks at SERVE_LOGITS_RTOL.  MLA never
# runs flash_attention: the reference's mla_apply has no use_flash
SERVE_MOE_ARCH, SERVE_MOE_PARAMS = "deepseek_v2_lite_16b", 16_210_311_168
# [serve_moe_gqa]: qwen3-moe-30b-a3b (src/repro_torch/configs/
# qwen3_moe_30b_a3b.py: d_model 2048, 32 query heads over 4 KV heads of 128,
# 128 routed experts of 768, top 8, vocab 151936) at full width with its
# depth cut from 48 to 24 layers: all 48 are 30.5 B parameters, 122 GB in
# float32, beyond the card's 80 GB; 24 are 15.6 B, 62.3 GB
SERVE_MOE_GQA_ARCH, SERVE_MOE_GQA_LAYERS = "qwen3_moe_30b_a3b", 24
SERVE_MOE_GQA_PARAMS = 15_577_745_408
# [train_moe]: a TRAIN_MOE_LAYERS-layer cut of deepseek-v2-lite's widths (full
# vocab) in float32, AdamW, remat "none", TRAIN_MOE_STEPS make_train_step
# steps of TRAIN_MOE_BATCH x TRAIN_MOE_SEQ tokens: training routes at
# capacity (1.25 x the mean load), so pairs drop
TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS, TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 2, 3, 2, 512
TRAIN_MOE_PARAMS = 1_589_127_168
# [flash_attention]: the kernel against its plain version within the
# reference's own tolerances for its kernel (tests/test_kernels.py): float32
# 2e-5, bf16 3e-2.  Cases (label, B, Hq, Hkv, Sq, Skv, d, causal, dtype): the
# serving prefill's shape, a ragged length and full (non-causal) MHA in
# float32 (the fp32 body) and bf16 (the wgmma body), MQA, one long causal
# case held against the plain chunked form (``_sdpa_chunked``, the
# reference's own path above ATTN_CHUNK_THRESHOLD = 4096 query rows), and
# Phi-3-mini's attention (32 heads of d = 96, no GQA) at the serving
# prefill's batch and length, the fp32 body's d = 96 instance
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
FLASH_CASES = (
    ("full_width", 4, 16, 2, 2048, 2048, 128, True, torch.float32),
    ("full_width", 4, 16, 2, 2048, 2048, 128, True, torch.bfloat16),
    ("ragged", 4, 16, 2, 1000, 1000, 128, True, torch.float32),
    ("ragged", 4, 16, 2, 1000, 1000, 128, True, torch.bfloat16),
    ("mha_full", 4, 16, 16, 1024, 1024, 128, False, torch.float32),
    ("mha_full", 4, 16, 16, 1024, 1024, 128, False, torch.bfloat16),
    ("mqa", 4, 16, 1, 2048, 2048, 128, True, torch.float32),
    ("long", 1, 16, 2, 8192, 8192, 128, True, torch.float32),
    ("phi3_mini", 4, 32, 32, 2048, 2048, 96, True, torch.float32),
    # qwen3-moe-30b-a3b's attention (32 query heads over 4 KV heads of 128),
    # [serve_moe_gqa]'s prefill shape
    ("moe_gqa", 4, 32, 4, 2048, 2048, 128, True, torch.float32),
    # head dims above 128: DeepSeek-V2-Lite's query-key width (192, its 16
    # heads, no GQA) and d = 256 (float32 as two blocks of 128 columns of O),
    # at batch 2 (the time budget)
    ("deepseek_qk", 2, 16, 16, 2048, 2048, 192, True, torch.float32),
    ("deepseek_qk", 2, 16, 16, 2048, 2048, 192, True, torch.bfloat16),
    ("d256", 2, 16, 16, 2048, 2048, 256, True, torch.float32),
    ("d256", 2, 16, 16, 2048, 2048, 256, True, torch.bfloat16),
    # above 256, the wide instances (O in blocks of 128 columns, q . k over
    # d in chunks of 128), at batch 1
    ("d320", 1, 16, 16, 2048, 2048, 320, True, torch.float32),
    ("d320", 1, 16, 16, 2048, 2048, 320, True, torch.bfloat16),
    ("d512", 1, 16, 16, 2048, 2048, 512, True, torch.float32),
    ("d512", 1, 16, 16, 2048, 2048, 512, True, torch.bfloat16),
)
#: flash_attention's instances: (body, head dim), body 0 the fp32 body and
#: 1 the wgmma body (``flash_attention_instance_info``); d = 320 names each
#: body's wide instance (every d above 256)
FLASH_INSTANCES = ((0, 32), (0, 64), (0, 96), (0, 128), (0, 160), (0, 192), (0, 256),
                   (0, 320), (1, 16), (1, 32), (1, 64), (1, 128), (1, 192), (1, 256),
                   (1, 320))
# [path] / [path_kernels] / [select]: benchmarks/bench_select.py's workload
# at its own size, structured_synthetic(60, 40, tree_frac=0.2,
# chordal_frac=0.2, seed=1) (p = 2400), 20 lambdas linspace(0.75, 0.32),
# output "sparse", tol 1e-7, and its two gates: warm within 1e-5 of the
# cold-restart loop block by block, warm fraction >= 0.5.  The plain
# versions of the path's bucket_glasso launches run on CPU copies in a pool
# of PATH_PLAIN_WORKERS processes.  EBIC's sample count is bench_select's
# own (its served-selection check passes n = 150 with a covariance)
PATH_CASE = (60, 40)
PATH_GRID = (0.75, 0.32, 20)
PATH_TOL = 1e-7
PATH_WARM_GATE = 1e-5
PATH_WARM_FRACTION = 0.5
PATH_PLAIN_WORKERS = 8
SELECT_N = 150
# [path_from_data] / [select] cv, stars: [from_data]'s workload (p = 8000,
# n = 192, tile 2048) over 6 lambdas evenly spaced from 0.40 to 0.30; StARS
# with 4 subsamples
PATH_FD_GRID = (0.40, 0.30, 6)
STARS_SUBSAMPLES = 4
# [fused]: the planted case's chordless cycles (structure "general"), sizes
# covering every bin and every b mod 4 in the b <= 32 bins, coupled by
# 0.25 at lam = 0.25, an exact tie (dyadic entries)
# [serve_glasso]: the dense requests' lambdas on [main]'s S and the seeds of
# the other four (lam 0.6); rows appended to the session; the batching
# window (long enough for the four threads' host screens to meet in one
# batch); served Theta within SERVE_THETA_RTOL max|Theta| of its direct
# solve (the same kernels on the same stacks: equal bits expected), the
# appended solve (warm) within SERVE_APPEND_RTOL of a cold solve of the
# stacked data (the reference's own tolerance for it)
SERVE_GLASSO_LAMS = (0.58, 0.60, 0.62, 0.65)
SERVE_GLASSO_SEEDS = (1, 2, 3, 4)
SERVE_GLASSO_THREADS = 4
SERVE_APPEND_ROWS = 16
SERVE_GLASSO_WINDOW = 1.0
SERVE_THETA_RTOL = 1e-9
SERVE_APPEND_RTOL = 1e-5
FUSED_SIZES = (4, 5, 6, 7, 10, 14, 22, 27, 40, 63)
FUSED_LAM = 0.25


#: [multidevice]: d row shards on the one card (cuda:0 repeated), every
#: shard's work and every copy between shards on that card
MULTI_D = 4
#: the giant block at d = MULTI_D and at d = 1 each take this many outer
#: ADMM iterations from the same cold start, and the two iterates are
#: compared.  A depth cut: the d = 4 solve to convergence (1363 iterations
#: from the d = 1 solution at 1.05 lam) took 74-184 s on four shards of one
#: card, launch- and host-bound, and held chip_smoke.py above 600 s; the
#: d = 1 solve's convergence stays checked in [oversize] (its in-place KKT
#: and the dense admm oracle)
GIANT_MD_ITERS = 50

T_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One result line, stamped with the seconds since the script started."""
    fields["t"] = f"{time.perf_counter() - T_START:.1f}"
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


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds to issue ``fn()`` (no synchronisation inside
    the window: the enqueue cost, which bounds a launch-bound loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / reps


def sha(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two runs
    that print the same digest computed the same bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


@contextmanager
def record_calls(module: str, name: str):
    """Record the arguments of every call to ``module.name`` made inside the
    block (the function itself still runs, launch counter and all): the
    kernel rows of the JSON line time each kernel on exactly the inputs its
    path gave it."""
    mod = importlib.import_module(module)
    inner = getattr(mod, name)
    calls: list[tuple[tuple, dict]] = []

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(mod, name, recording)
    try:
        yield calls
    finally:
        setattr(mod, name, inner)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def tree_bound_ms(B: int, b: int) -> float:
    return 2 * B * b * b * 8 / HBM_BYTES_PER_S * 1e3


def ns_per_step(ms: float, steps: int) -> float:
    """Nanoseconds of kernel time a link of the serial chain: ``ms`` over
    ``steps`` dependent coordinate updates (0.0 without any)."""
    return ms * 1e6 / steps if steps else 0.0


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


def ptxas_entries(out: str) -> dict[str, dict]:
    """Each entry function's registers, stack frame and spill bytes from
    ``nvcc -Xptxas -v``'s report, by mangled name."""
    entries: dict[str, dict] = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entries[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            entries[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries[name]["registers"] = int(m.group(1))
    return entries


def phase_build() -> None:
    path, seconds, out = kbuild.build()
    if out:  # the compiler's full report, beside the library it built
        path.with_suffix(".log").write_text(out)
    elif path.with_suffix(".log").is_file():  # built earlier by this checkout
        out = path.with_suffix(".log").read_text()
    lib = kbuild.library()
    usage = [ln.strip() for ln in out.splitlines() if "registers" in ln]
    # bucket_glasso's instances: float64 / float32 ("d" / "f"), rows a lane
    # keeps in registers (chunks of 32; 0: in shared memory)
    bucket = []
    for name, info in sorted(ptxas_entries(out).items()):
        m = re.search(r"bucket_glasso_kernelI([df])Li(\d+)E", name)
        if m:
            bucket.append(dict(dtype={"d": "float64", "f": "float32"}[m.group(1)],
                               chunks=int(m.group(2)), **info))
    log("build", seconds=f"{seconds:.3f}", library=path.name,
        bucket_glasso_spill_bytes=sum(i.get("spill_stores", 0) + i.get("spill_loads", 0)
                                      for i in bucket),
        bucket_glasso_max_registers=max((i.get("registers", 0) for i in bucket), default=0),
        ptxas="; ".join(usage))
    for info in bucket:
        log("bucket_instances", **info)
    # covgram's instances: float32 / bf16 X, TMA stores or the plain-store
    # epilogue (p not a multiple of 4)
    for name, info in sorted(ptxas_entries(out).items()):
        m = re.search(r"covgram_kernelI(f|13__nv_bfloat16)Lb([01])E", name)
        if m:
            log("covgram_instances", dtype={"f": "float32"}.get(m.group(1), "bfloat16"),
                stores=("plain", "tma")[int(m.group(2))], **info)
    log("card", nvidia_smi=json.dumps(card_line()), torch=torch.__version__,
        cuda=torch.version.cuda)
    for body, d in FLASH_INSTANCES:
        info = (ctypes.c_int * 4)()
        kbuild.check(lib.flash_attention_instance_info(body, d, info), "flash_attention")
        # local bytes: a thread's spills and stack (0: nothing spilled)
        log("flash_instances", body=("fp32", "wgmma")[body], d=d, registers=info[0],
            local_bytes=info[1], dynamic_smem_bytes=info[2], blocks_per_sm=info[3],
            warps_per_sm=info[3] * (4 if body == 0 else 8))


#: the card tests run as a phase: those of the kernels redesigned last,
#: on shapes the paths never give them (ragged and odd tiles, head dims
#: off the instances, unaligned views, K above 113, scratch reuse,
#: bit-identical sums, b at each shared-memory limit, every form of t)
CARD_TESTS = ("flash_attention or covgram_screen or joint_prox or bucket_glasso or prox_l1"
              " or covgram or tree_glasso or scratch_wrappers or glasso_server"
              " or threshold_cc_row_slab")


#: card-test processes run side by side: the bucket_glasso tests spend
#: their time in the plain version's host loop, one CPU core each (one
#: thread each: the loop's tensors are too small to split)
CARD_TEST_SHARDS = 8


def card_test_weight(test_id: str) -> float:
    """A card test's rough seconds, for dealing them out: the
    bucket_glasso cases spend their time in the plain version's loop, which
    grows as b^2, about four times faster on dense covariances than on the
    planner's general lanes (b = 96 on dense ones: 14 s); any other test
    ~0.2 s."""
    m = re.search(r"bucket_glasso_matches_plain\[([^-\]]+)-\d+-dtype\d+-(\w+)\]", test_id)
    if m is None:
        return 0.2
    b = {"w_max": 168, "w_max+1": 169}.get(m.group(1)) or int(m.group(1))
    return b * b / (650.0 if m.group(2) == "cov" else 2800.0)


def phase_card_tests() -> None:
    """``tests/test_torch_cuda_kernels.py -k CARD_TESTS`` in
    ``CARD_TEST_SHARDS`` subprocesses at once, the collected tests dealt
    out by ``card_test_weight`` (no conftest: it imports JAX, which the
    port's machine need not have); fails unless every shard passes with
    nothing skipped."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           "tests/test_torch_cuda_kernels.py"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    collected = subprocess.run(cmd + ["-k", CARD_TESTS, "--collect-only"], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=300)
    ids = [ln for ln in collected.stdout.splitlines()
           if ln.startswith("tests/test_torch_cuda_kernels.py::") and " " not in ln]
    if collected.returncode != 0 or not ids:
        print(collected.stdout[-4000:], collected.stderr[-2000:], sep="\n", flush=True)
        raise AssertionError(f"card tests: collection failed (exit {collected.returncode})")
    # longest first, each to the shard with the least work so far
    shards: list[list[str]] = [[] for _ in range(min(CARD_TEST_SHARDS, len(ids)))]
    work = [0.0] * len(shards)
    for test in sorted(ids, key=card_test_weight, reverse=True):
        k = work.index(min(work))
        shards[k].append(test)
        work[k] += card_test_weight(test)
    procs = [subprocess.Popen(cmd + shard, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for shard in shards]
    results, failed = [], False
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            lines = out.strip().splitlines()
            results.append(lines[-1] if lines else "")
            if proc.returncode != 0 or not lines or "skipped" in lines[-1]:
                print(out[-6000:], err[-2000:], sep="\n", flush=True)
                failed = True
    finally:
        for proc in procs:
            proc.kill()
    log("card_tests", selection=json.dumps(CARD_TESTS), tests=len(ids),
        shards=json.dumps(results), seconds=f"{time.perf_counter() - t0:.1f}")
    if failed:
        raise AssertionError("card tests failed or skipped")


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
    """Kernel against plain version on one stack; raises on disagreement.
    The check runs the plain version on CPU copies of the inputs (launch-
    bound on the card, it takes several times as long there); with
    ``time_plain`` the plain version is also timed on the card
    (``plain_ms``, else None)."""
    N, b, _ = S.shape
    scales = convergence_scale(S)
    cd = torch.empty(N, dtype=torch.int64, device=DEV)
    theta, sweeps = fused_bcd_stack(S, lams, scales, W0, T0, cd_sweeps=cd)
    cd_ref = torch.empty(N, dtype=torch.int64)
    theta_ref, sweeps_ref = fused_bcd_ref_stack(
        *(x.cpu() for x in (S, lams, scales, W0, T0)), cd_sweeps=cd_ref)
    theta_ref, sweeps_ref, cd_ref = (x.to(DEV) for x in (theta_ref, sweeps_ref, cd_ref))
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
    plain_ms = (cuda_ms(lambda: fused_bcd_ref_stack(S, lams, scales, W0, T0), 1)
                if time_plain else None)
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
                bound_ms=f"{r['bound_ms']:.6f}",
                bytes_ms=f"{r['bytes_ms']:.6f}", ops_ms=f"{r['ops_ms']:.6f}",
                serial_steps=r["chain"], ns_per_step=f"{ns_per_step(r['ms'], r['chain']):.1f}",
                smem_bytes=kbuild.library().bucket_glasso_smem_bytes(b, 8))


# ------------------------------------------------------------------ phase 4


def span_seconds(res, name: str) -> float:
    """Seconds of every span called ``name`` in the result's trace, at any
    depth (a from-data solve nests the engine's run under its screen)."""
    if res.trace is None:
        return 0.0
    return sum(sp.seconds for sp in res.trace.spans if sp.name == name)


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


def solve_on_card(name: str, S: np.ndarray, lam: float, *, phase: str = "main",
                  options: EngineOptions | None = None):
    """One solve on the card (default options unless given), checked;
    returns (its kernel launches, the result).  The launch counters are
    zeroed just before the solve and read just after.  The first solve of
    the process also pays the CUDA libraries' one-time set-up (the batched
    inverse of the KKT check)."""
    torch.cuda.synchronize()
    instrument.reset("kernels.")
    t0 = time.perf_counter()
    res = glasso(S, lam, options=options or EngineOptions())
    wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    kkt = check_solution(S, lam, res)
    stages = res.stages()
    plan_s = span_seconds(res, "engine.plan")
    log(phase, case=name, p=S.shape[0], lam=f"{lam:.6g}", device=res.device,
        route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), kkt=kkt,
        max_abs_S=float(np.abs(S).max()), wall_s=f"{wall:.3f}",
        screen_s=f"{stages['screen']:.4f}", plan_s=f"{plan_s:.4f}",
        solve_s=f"{stages['solve']:.4f}", dispatch_s=f"{stages['dispatch']:.4f}",
        assemble_s=f"{stages['assemble']:.4f}")
    return launches, res


def main_path_kernels(S: np.ndarray, lam: float) -> list[dict]:
    """Time each kernel against its plain version on the stacks the main
    path hands it (the same plan the solve built)."""
    labels, _ = thresholded_components(S, lam)
    plan, _ = build_plan_incremental(S, lam, labels)
    tree = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, device_ms=0.0, host_ms=0.0,
                n=0)
    bucket = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes_ms=0.0, ops_ms=0.0,
                  chain=0, chain_sum=0, ms_f32=0.0)
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
            events, device_ms = profile_calls(lambda: glasso_forest_stack(blocks, lams), 10,
                                              name="tree_glasso")
            issue_ms = host_ms(lambda: glasso_forest_stack(blocks, lams), 50)
            log("main_tree", structure=bk.structure, b=b, N=n, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=tree_bound_ms(n, b), device_ms=device_ms,
                host_ms=f"{issue_ms:.4f}", device_events_per_call=json.dumps(events),
                sha256=sha(got))
            tree["err"] = max(tree["err"], err)
            tree["ms"] += ms
            tree["plain_ms"] += plain_ms
            tree["bound_ms"] += tree_bound_ms(n, b)
            tree["device_ms"] += device_ms
            tree["host_ms"] += issue_ms
            tree["n"] += 1
        elif route == "iterative":
            eye = torch.eye(b, dtype=torch.float64, device=DEV)
            args = (blocks, lams, blocks + lams[:, None, None] * eye,
                    eye.expand(n, b, b).contiguous())
            r = compare_bucket(*args, f"main b={b}")
            # the float32 instance on float32 copies of the same stack
            a32 = as_f32(args)
            s32 = convergence_scale(a32[0])
            r["ms_f32"] = cuda_ms(lambda: fused_bcd_stack(a32[0], a32[1], s32, *a32[2:]), 3)
            log("main_bucket", b=b, N=n, sweeps=r["sweeps"].tolist(), max_abs_err=r["err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bytes_ms=r["bytes_ms"],
                ops_ms=r["ops_ms"], serial_steps=r["chain"],
                ns_per_step=f"{ns_per_step(r['ms'], r['chain']):.1f}", ms_f32=r["ms_f32"])
            for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "ms_f32"):
                bucket[k] += r[k]
            bucket["err"] = max(bucket["err"], r["err"])
            bucket["chain"] = max(bucket["chain"], r["chain"])
            bucket["chain_sum"] += r["chain"]
    return [tree, bucket]


def log_main_kernels(tree: dict, bucket: dict) -> None:
    """The [main_kernels] line: the dense plan's kernels summed over its
    stacks; ``bucket_ns_per_step`` over the launches' longest chains
    summed (the launches run one after another)."""
    log("main_kernels", tree_ms=tree["ms"], tree_plain_ms=tree["plain_ms"],
        tree_bound_ms=tree["bound_ms"], tree_device_ms=tree["device_ms"],
        tree_host_ms_a_call=tree["host_ms"] / max(tree["n"], 1), bucket_ms=bucket["ms"],
        bucket_plain_ms=bucket["plain_ms"], bucket_bytes_ms=bucket["bytes_ms"],
        bucket_ops_ms=bucket["ops_ms"], bucket_serial_steps=bucket["chain"],
        bucket_serial_steps_summed=bucket["chain_sum"],
        bucket_ns_per_step=f"{ns_per_step(bucket['ms'], bucket['chain_sum']):.1f}",
        bucket_ms_f32=bucket["ms_f32"])


def phase_main_kernels() -> None:
    """The p = 6000 main case's kernels on their own inputs, alone (for
    ``scripts/compare_turns.py``): every tree_glasso and bucket_glasso
    stack of the dense plan against its plain version ([main_tree],
    [main_bucket], [main_kernels]), then one ``solver="pg"`` solve whose
    first, middle and last prox_l1 launches are checked and timed
    ([prox_l1])."""
    S = structured_synthetic(*MAIN_CASE, seed=0)
    log_main_kernels(*main_path_kernels(S, SCREEN_LAM))
    module, name, _ = SOLVER_KERNELS["pg"]
    with record_prox_launches(module, name) as kept:
        glasso(S, SCREEN_LAM, options=EngineOptions(solver="pg", solver_opts=SOLVER_OPTS))
    log_prox_l1(prox_l1_on_path(kept))


# ------------------------------------------------------------ phases 5-9


def workload(p: int, *, load: float, noise: float, seed: int = 0) -> np.ndarray:
    """(n, p) data of the benchmarks' from-data arms: groups of 8 columns
    in the leading tiles share one factor (``load``) over power-law column
    scales.  ``benchmarks/bench_sparse.py`` uses load 0.9, noise 0.44 (the
    dense-from-data arm: near-equicorrelated groups); ``bench_stream.py``
    load 0.75, noise 0.66 (the streaming-screen arm)."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    scales = 0.04 + 0.96 * (1.0 - np.arange(p) / p) ** 4
    X = rng.standard_normal((n, p)) * scales
    n_groups = max(2, p // 400)
    f = rng.standard_normal((n, n_groups))
    for g in range(n_groups):
        cols = slice(g * 8, g * 8 + 8)
        X[:, cols] = load * f[:, [g]] + noise * X[:, cols] / scales[cols]
    return X


def canonical(comp: np.ndarray) -> np.ndarray:
    """Component ids -> each vertex labelled by its component's smallest
    vertex."""
    first = np.full(comp.max() + 1, comp.size)
    np.minimum.at(first, comp, np.arange(comp.size))
    return first[comp]


def dense_partition(S_dev: torch.Tensor, lam: float) -> tuple[np.ndarray, float]:
    """Canonical labels of |S_ij| > lam on a dense S on the card (edges by
    torch.nonzero, components by scipy), and the margin min ||S_ij| - lam|
    over the off-diagonal entries."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    p = S_dev.shape[0]
    A = S_dev.abs()
    ij = torch.nonzero(torch.triu(A > lam, diagonal=1)).cpu().numpy()
    d = (A - lam).abs_()
    d.fill_diagonal_(float("inf"))
    margin = float(d.min())
    del A, d
    G = coo_matrix((np.ones(len(ij)), (ij[:, 0], ij[:, 1])), shape=(p, p))
    _, comp = connected_components(G, directed=False)
    return canonical(comp), margin


def device_busy(phase: str, case: str, fn) -> None:
    """Run ``fn`` once under torch.profiler and log the device's busy
    seconds — the union of the time intervals of the device-side events
    (kernels and copies; the profiler's own buffer requests excluded) —
    against the wall seconds of the call.  A diagnostic: where the profiler
    records no device event, the line says "not measured" and no check
    depends on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    if not events:
        log(phase + "_profile", case=case, device_busy="not measured",
            reason="no device event recorded")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name[:40]] = by_name.get(e.name[:40], 0.0) + e.time_range.elapsed_us()
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(phase + "_profile", case=case, wall_s=f"{wall:.4f}", device_events=len(events),
        device_busy_s=f"{busy_us / 1e6:.4f}", idle_share=f"{1 - busy_us / 1e6 / wall:.4f}",
        top_device_ms=json.dumps({k: round(v / 1e3, 3) for k, v in top.items()}))


def threshold_cc_bound_ms(p: int, itemsize: int = 8) -> float:
    return p * p * itemsize / HBM_BYTES_PER_S * 1e3


def hook_steps_on_path(steps: list) -> dict:
    """Each recorded hook step of a path against its plain version (labels
    equal), and the CUDA-event times of kernel and plain version on that
    step's own inputs, summed over the steps."""
    out = dict(n=len(steps), ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0)
    for (S_dev, labels, lam), _ in steps:
        got = labelprop_step(S_dev, labels, lam)
        want = labelprop_step_ref(S_dev, labels, lam)
        out["err"] = max(out["err"], int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError("threshold_cc: a hook step of the path differs from plain")
        out["ms"] += cuda_ms(lambda: labelprop_step(S_dev, labels, lam), 5)
        out["plain_ms"] += cuda_ms(lambda: labelprop_step_ref(S_dev, labels, lam), 2)
        p = S_dev.shape[0]
        out["bound_ms"] += (S_dev.numel() * S_dev.element_size() + 2 * p * 4) \
            / HBM_BYTES_PER_S * 1e3
    return out


def in_background(fn, *args):
    """Start ``fn(*args)`` on a daemon thread; returns a function that joins
    it and returns its value (or raises its exception)."""
    import threading

    box: dict = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by the join
            box["error"] = e

    thread = threading.Thread(target=run, name=fn.__name__, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box.pop("value")

    return join


def phase_threshold_cc(matrices) -> None:
    """The hook step at the two fixed shapes, from the first round's labels.
    ``matrices`` holds a function a case of THRESHOLD_CC_CASES, in order,
    returning its ``structured_synthetic(K, p1, seed=0)``: [main]'s matrix,
    and the join of a background thread making the p = 20016 one (20-30 s
    of numpy on the host, made while [card_tests]' subprocesses run)."""
    for (K, p1), matrix in zip(THRESHOLD_CC_CASES, matrices, strict=True):
        S = matrix()
        p = S.shape[0]
        if p != K * p1:
            raise AssertionError(f"threshold_cc: a p = {p} matrix for the case {(K, p1)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S_dev = torch.as_tensor(S).to(DEV)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        labels0 = torch.arange(p, dtype=torch.int32, device=DEV)
        got = labelprop_step(S_dev, labels0, SCREEN_LAM)
        want = labelprop_step_ref(S_dev, labels0, SCREEN_LAM)
        if not torch.equal(got, want):
            raise AssertionError(f"threshold_cc p={p}: hook step differs from the plain version")
        ms = cuda_ms(lambda: labelprop_step(S_dev, labels0, SCREEN_LAM), 20)
        plain_ms = cuda_ms(lambda: labelprop_step_ref(S_dev, labels0, SCREEN_LAM), 3)
        instrument.reset("screen.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = connected_components_kernel(S_dev, SCREEN_LAM).cpu().numpy()
        cc_s = time.perf_counter() - t0
        rounds = instrument.count("screen.labelprop_rounds")
        t0 = time.perf_counter()
        host = components_from_covariance_host(S, SCREEN_LAM)
        host_s = time.perf_counter() - t0
        if not np.array_equal(labels, host):
            raise AssertionError(f"threshold_cc p={p}: labels differ from the host union-find")
        bound = threshold_cc_bound_ms(p)
        log("threshold_cc", K=K, p1=p1, p=p, lam=SCREEN_LAM, ms_per_step=f"{ms:.4f}",
            plain_ms_per_step=f"{plain_ms:.4f}", bound_ms_per_step=f"{bound:.4f}",
            rounds=rounds, fixed_point_s=f"{cc_s:.4f}", h2d_ms=f"{h2d_ms:.2f}",
            host_unionfind_s=f"{host_s:.4f}", n_components=int(np.unique(host).size),
            labels_equal_host=True)
        del S, S_dev, got, want
        torch.cuda.empty_cache()


def phase_screen(S: np.ndarray, lam: float, host_res) -> tuple[dict[str, int], dict]:
    """The dense main path with the device screen; returns the launches of
    its first solve and the hook steps of that solve, each timed on its own
    inputs."""
    opts = EngineOptions(cc_backend="pallas")
    name = "structured K={} p1={} cc_backend=pallas".format(*MAIN_CASE)
    with record_calls("repro_torch.kernels.threshold_cc.ops", "labelprop_step") as steps:
        launches, res = solve_on_card(name, S, lam, phase="screen", options=opts)
    if len(steps) != launches.get("threshold_cc.launches", 0):
        raise AssertionError(f"{len(steps)} hook steps recorded, {launches} launched")
    _, again = solve_on_card(name + " (repeat)", S, lam, phase="screen", options=opts)
    for r in (res, again):
        if not np.array_equal(r.labels, host_res.labels):
            raise AssertionError("the device screen's labels differ from the host screen's")
        if r.route_mix != host_res.route_mix:
            raise AssertionError(f"route mix {r.route_mix} != host run's {host_res.route_mix}")
    if launches.get("threshold_cc.launches", 0) <= 0:
        raise AssertionError("threshold_cc was not launched on the [screen] path")
    device_busy("screen", "pallas repeat, profiled",
                lambda: glasso(S, lam, options=opts))
    t0 = time.perf_counter()
    n_edges = count_edges(S, lam)
    host_count_s = time.perf_counter() - t0
    S_dev = torch.as_tensor(S).to(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if count_edges(S_dev, lam) != n_edges:
        raise AssertionError("count_edges on the card differs from the host count")
    log("screen_count_edges", p=S.shape[0], n_edges=n_edges,
        host_count_s=f"{host_count_s:.4f}",
        device_count_s=f"{time.perf_counter() - t0:.4f}",
        host_screen_s=f"{host_res.stages()['screen']:.4f}",
        device_screen_s=f"{again.stages()['screen']:.4f}")
    del S_dev
    path = hook_steps_on_path(steps)
    log("screen_kernels", hook_steps=path["n"], max_abs_err=path["err"],
        ms=f"{path['ms']:.4f}", plain_ms=f"{path['plain_ms']:.4f}",
        bound_ms=f"{path['bound_ms']:.4f}")
    del steps
    torch.cuda.empty_cache()
    return launches, path


def _kept_pairs(X: np.ndarray, tile: int, lam_min: float):
    """The tile pairs the stream screen computes (its moments pass and
    Cauchy-Schwarz schedule), the number it skips, and the column means."""
    mom = column_moments(X, chunk=CHUNK)
    ti, tj, keep = tile_pair_schedule(tile_maxima(mom.norms, tile), lam_min, slack=1e-6)
    return ti[keep].astype(np.int32), tj[keep].astype(np.int32), int((~keep).sum()), mom.mu


def covgram_bound(N: int, P: int, B: int, bp: int, *, itemsize: int = 8,
                  flops_per_s: float = FP64_FLOPS_PER_S) -> tuple[float, float]:
    """(bytes ms, operations ms): vals written and X read once; 2 N bp^2
    flops per pair at the FP64 tensor-core peak (float32: the FP32 rate
    outside the tensor cores, 4-byte values)."""
    t_bytes = (B * bp * bp + N * P + P) * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * N * bp * bp * B / flops_per_s * 1e3
    return t_bytes, t_ops


def covgram_measure(label: str, x_pad, mu_pad, ti, tj, lam: float, *, n_true: int,
                    p_true: int, block_p: int) -> dict:
    """covgram_screen against its plain version and the library Gram on one
    launch's inputs: raises on disagreement or on a call that is more than
    its one kernel; returns the error, the bound and the CUDA-event, device
    and host times of a call with the tile indices as int32 tensors on the
    card, the form the paths pass (``ms_host_indices``: the same call with
    numpy indices, which adds their two host-to-device copies)."""
    ti = torch.as_tensor(ti, dtype=torch.int32, device=x_pad.device)
    tj = torch.as_tensor(tj, dtype=torch.int32, device=x_pad.device)
    args = (x_pad, mu_pad, ti, tj, lam)
    kw = dict(n_true=n_true, p_true=p_true, block_p=block_p)
    got = covgram_screen_tiles(*args, **kw)
    want = covgram_screen_ref(*args, **kw)
    scale = float(want[2][:, 0].max()) if len(ti) else 1.0
    err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
    if not err <= COVGRAM_RTOL * scale:
        raise AssertionError(
            f"covgram_screen {label}: max|diff|={err} > {COVGRAM_RTOL}*{scale}")
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"covgram_screen {label}: edge counts differ from the plain version")
    edges = int(got[1].sum())
    del got, want
    ms = cuda_ms(lambda: covgram_screen_tiles(*args, **kw), 5)
    events, device_ms = profile_calls(lambda: covgram_screen_tiles(*args, **kw), 20,
                                      "covgram_screen")
    issue_ms = host_ms(lambda: covgram_screen_tiles(*args, **kw), 20)
    if len(events) != 1 or "covgram_screen" not in next(iter(events)) \
            or not 0.0 < next(iter(events.values())) <= 1.0:
        raise AssertionError(f"covgram_screen {label}: device events a call {events}")
    ti_np, tj_np = ti.cpu().numpy(), tj.cpu().numpy()
    ms_host_indices = cuda_ms(
        lambda: covgram_screen_tiles(x_pad, mu_pad, ti_np, tj_np, lam, **kw), 5)
    plain_ms = cuda_ms(lambda: covgram_screen_ref(*args, **kw), 2)
    # library yardstick: cuBLAS DGEMM on the centered tile batch, then the
    # threshold — it computes vals only (no counts, no stats)
    N, P = x_pad.shape
    nt = P // block_p
    xt, mt = x_pad.reshape(N, nt, block_p), mu_pad.reshape(nt, block_p)
    idx_i, idx_j = ti.long(), tj.long()
    A = (xt[:, idx_i, :] - mt[idx_i]).permute(1, 2, 0).contiguous()
    Bm = (xt[:, idx_j, :] - mt[idx_j]).permute(1, 0, 2).contiguous()

    def library():
        G = torch.matmul(A, Bm).div_(n_true)
        return torch.where(G.abs() > lam, G, 0.0)

    library_ms = cuda_ms(library, 5)
    t_bytes, t_ops = covgram_bound(N, P, len(ti), block_p)
    del A, Bm
    torch.cuda.empty_cache()
    return dict(err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes_ms=t_bytes, ops_ms=t_ops, pairs=len(ti), edges=edges, events=events,
                host_ms=issue_ms, ms_host_indices=ms_host_indices)


def covgram_case(label: str, X: np.ndarray, tile: int, lam: float, max_pairs: int) -> dict:
    """covgram_screen on one batch of the pairs a data path schedules."""
    n, p = X.shape
    ti, tj, skipped, mu = _kept_pairs(X, tile, lam)
    ti, tj = ti[:max_pairs], tj[:max_pairs]
    x_pad, mu_pad = pad_for_screen(torch.as_tensor(X).to(DEV), mu, block_n=CHUNK, block_p=tile)
    r = covgram_measure(label, x_pad, mu_pad, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    bound = max(r["bytes_ms"], r["ops_ms"])
    log("covgram_screen", case=label, n=n, p=p, tile=tile, pairs=r["pairs"],
        skipped_pairs=skipped, lam=lam, max_abs_err=r["err"], edges=r["edges"], mma=MMA,
        ms=f"{r['ms']:.4f}", device_ms=f"{r['device_ms']:.4f}", host_ms=f"{r['host_ms']:.4f}",
        ms_host_indices=f"{r['ms_host_indices']:.4f}",
        plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
        bytes_ms=f"{r['bytes_ms']:.4f}", ops_ms=f"{r['ops_ms']:.4f}",
        bound_share=f"{bound / r['device_ms']:.3f}" if r["device_ms"] else "not measured",
        gflops=f"{2.0 * x_pad.shape[0] * tile * tile * r['pairs'] / r['ms'] / 1e6:.1f}",
        device_events_per_call=json.dumps(r["events"]))
    return r


def covgram_case_f32(label: str, X: np.ndarray, tile: int, lam: float,
                     max_pairs: int) -> dict:
    """The float32 body of covgram_screen on float32 copies of one batch of
    a data path's pairs, against its plain version at float32: stats and
    the values of common edges within COVGRAM_F32_RTOL max|S|, edges and
    counts equal except at entries within that of lam (counted, from the
    float64 plain version's |S_ij|); timed beside its bound (FP32 FMAs,
    4-byte values), the plain version and the float32 library product."""
    n, p = X.shape
    ti, tj, _, mu = _kept_pairs(X, tile, lam)
    ti = torch.as_tensor(ti[:max_pairs], device=DEV)
    tj = torch.as_tensor(tj[:max_pairs], device=DEV)
    x_pad, mu_pad = pad_for_screen(torch.as_tensor(X, dtype=torch.float32, device=DEV),
                                   mu, block_n=CHUNK, block_p=tile)
    args, kw = (x_pad, mu_pad, ti, tj, lam), dict(n_true=n, p_true=p, block_p=tile)
    instrument.reset("kernels.")
    got = covgram_screen_tiles(*args, **kw)
    want = covgram_screen_ref(*args, **kw)
    if instrument.count("kernels.covgram_screen.launches") != 1 or got[0].dtype != torch.float32:
        raise AssertionError(f"covgram_screen {label}: not one float32 launch")
    exact = covgram_screen_ref(x_pad.double(), mu_pad.double(), ti, tj, 0.0, **kw)[0].abs()
    scale = float(want[2][:, 0].max())
    tol = COVGRAM_F32_RTOL * scale
    both = (got[0] != 0) & (want[0] != 0)
    err = max(float((got[2] - want[2]).abs().max()),
              float((got[0] - want[0])[both].abs().max()) if bool(both.any()) else 0.0)
    near_lam = (exact - lam).abs() < tol
    flipped = (got[0] != 0) != (want[0] != 0)
    if not err <= tol or bool((flipped & ~near_lam).any()):
        raise AssertionError(f"covgram_screen {label}: max|diff| {err} > {tol}, or an edge "
                             "away from lam differs")
    n_near = int(near_lam.sum())
    count_diff = int((got[1] - want[1]).abs().sum())
    if count_diff > n_near:
        raise AssertionError(f"covgram_screen {label}: counts differ by {count_diff} with "
                             f"{n_near} entries near lam")
    del got, want, exact
    ms = cuda_ms(lambda: covgram_screen_tiles(*args, **kw), 5)
    _, device_ms = profile_calls(lambda: covgram_screen_tiles(*args, **kw), 20, "covgram_screen")
    plain_ms = cuda_ms(lambda: covgram_screen_ref(*args, **kw), 2)
    N, P = x_pad.shape
    nt = P // tile
    xt, mt = x_pad.reshape(N, nt, tile), mu_pad.reshape(nt, tile)
    A = (xt[:, ti.long(), :] - mt[ti.long()]).permute(1, 2, 0).contiguous()
    Bm = (xt[:, tj.long(), :] - mt[tj.long()]).permute(1, 0, 2).contiguous()

    def library():
        G = torch.matmul(A, Bm).div_(n)
        return torch.where(G.abs() > lam, G, 0.0)

    library_ms = cuda_ms(library, 5)
    del A, Bm
    t_bytes, t_ops = covgram_bound(N, P, len(ti), tile, itemsize=4, flops_per_s=FP32_FLOPS_PER_S)
    bound = max(t_bytes, t_ops)
    log("covgram_screen", case=label, dtype="float32", n=n, p=p, tile=tile, pairs=len(ti),
        lam=lam, max_abs_err=err, tol=tol, entries_near_lam=n_near, flipped_edges=int(
            flipped.sum()), count_diff=count_diff, ms=f"{ms:.4f}",
        device_ms=f"{device_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bytes_ms=f"{t_bytes:.4f}", ops_ms=f"{t_ops:.4f}",
        bound_share=f"{bound / device_ms:.3f}" if device_ms else "not measured")
    torch.cuda.empty_cache()
    return dict(err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by="operations" if t_ops > t_bytes else "bytes",
                entries_near_lam=n_near)


def phase_covgram_screen(X_fd: np.ndarray, X_st: np.ndarray) -> dict:
    """Both fixed shapes: the first batch of the pairs each data path
    schedules; then the float32 body on [from_data]'s batch (returned)."""
    covgram_case("from_data", X_fd, FROM_DATA_TILE, FROM_DATA_LAM, PAIR_BATCH)
    covgram_case("stream", X_st, STREAM_TILE, min(STREAM_GRID), PAIR_BATCH)
    return covgram_case_f32("from_data_f32", X_fd, FROM_DATA_TILE, FROM_DATA_LAM, PAIR_BATCH)


def covgram_launches_on_path(calls: list) -> dict:
    """Each recorded covgram_screen launch of a path, measured on its own
    inputs; errors and bounds combined, times summed."""
    out = dict(n=len(calls), err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, ms_host_indices=0.0)
    for k, (args, kw) in enumerate(calls):
        if not all(isinstance(a, torch.Tensor) and a.dtype == torch.int32 and a.is_cuda
                   for a in args[2:4]):
            raise AssertionError(f"covgram_screen path launch {k}: tile indices not int32 on "
                                 "the card")
        r = covgram_measure(f"path launch {k}", *args, **kw)
        out["err"] = max(out["err"], r["err"])
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                    "ms_host_indices"):
            out[key] += r[key]
        out["bound_ms"] += max(r["bytes_ms"], r["ops_ms"])
    return out


def phase_from_data(X: np.ndarray) -> tuple[dict[str, int], dict]:
    """glasso(X=...) on the card, checked; returns the launches of its first
    solve and that solve's covgram_screen launches, each measured on its
    own inputs."""
    n, p = X.shape
    lam = FROM_DATA_LAM
    S_dev = sample_covariance(X)
    S = S_dev.cpu().numpy()
    smax = float(np.abs(S).max())
    dense_labels, margin = dense_partition(S_dev, lam)
    if margin < MARGIN_RTOL * smax:
        raise AssertionError(
            f"from_data: an |S_ij| lies within {margin} of lam={lam}; pick data whose "
            "partition the sum order cannot flip"
        )
    host = components_from_covariance_host(S, lam)
    if not np.array_equal(host, dense_labels):
        raise AssertionError("from_data: host union-find and scipy disagree on the dense S")
    opts = EngineOptions(output="dense", solver_opts={"tol": 1e-9})
    stream = {"tile": FROM_DATA_TILE, "chunk": CHUNK}
    launches = None
    for case in ("first", "repeat"):
        torch.cuda.synchronize()
        instrument.reset("kernels.")
        instrument.reset("stream.")
        instrument.reset("router.fallback.")
        with record_calls("repro_torch.stream.screen", "covgram_screen_tiles") as recorded:
            t0 = time.perf_counter()
            res = glasso(X=X, lam=lam, from_data=True, stream=stream, options=opts)
            wall = time.perf_counter() - t0
        if launches is None:
            launches = instrument.tail_counts("kernels.")
            calls = recorded
        counters = instrument.counts("stream.")
        if not np.array_equal(res.labels, host):
            raise AssertionError("from_data: labels differ from the host union-find on dense S")
        kkt = check_solution(S, lam, res)
        stages = res.stages()
        plan_s = span_seconds(res, "engine.plan")
        log("from_data", case=case, n=n, p=p, lam=lam, tile=FROM_DATA_TILE, chunk=CHUNK,
            route_mix=json.dumps(res.route_mix, sort_keys=True),
            launches=json.dumps(instrument.tail_counts("kernels."), sort_keys=True),
            fallbacks=sum(instrument.tail_counts("router.fallback.").values()),
            kkt=kkt, max_abs_S=smax, margin=margin,
            tiles_total=counters.get("stream.tiles_total", 0),
            tiles_skipped=counters.get("stream.tiles_skipped", 0),
            edges_emitted=counters.get("stream.edges_emitted", 0),
            bytes_peak=counters.get("stream.bytes_peak", 0),
            wall_s=f"{wall:.3f}", screen_s=f"{stages['screen']:.4f}",
            stream_span_s=f"{span_seconds(res, 'engine.screen'):.4f}", plan_s=f"{plan_s:.4f}",
            solve_s=f"{stages['solve']:.4f}", dispatch_s=f"{stages['dispatch']:.4f}",
            assemble_s=f"{stages['assemble']:.4f}")
    if launches.get("covgram_screen.launches", 0) <= 0:
        raise AssertionError("covgram_screen was not launched on the [from_data] path")
    if len(calls) != launches["covgram_screen.launches"]:
        raise AssertionError(f"{len(calls)} covgram_screen calls recorded, {launches} launched")
    device_busy("from_data", "repeat, profiled",
                lambda: glasso(X=X, lam=lam, from_data=True, stream=stream, options=opts))
    del S_dev
    torch.cuda.empty_cache()
    path = covgram_launches_on_path(calls)
    log("from_data_kernels", covgram_launches=path["n"], max_abs_err=path["err"], mma=MMA,
        ms=f"{path['ms']:.4f}", device_ms=f"{path['device_ms']:.4f}",
        ms_host_indices=f"{path['ms_host_indices']:.4f}",
        plain_ms=f"{path['plain_ms']:.4f}", library_ms=f"{path['library_ms']:.4f}",
        bound_ms=f"{path['bound_ms']:.4f}", bytes_ms=f"{path['bytes_ms']:.4f}",
        ops_ms=f"{path['ops_ms']:.4f}",
        bound_share=(f"{path['bound_ms'] / path['device_ms']:.3f}" if path["device_ms"]
                     else "not measured"))
    return launches, path


def phase_stream(X: np.ndarray) -> None:
    """stream_screen over the grid; every partition equal to the dense one."""
    n, p = X.shape
    instrument.reset("stream.")
    instrument.reset("kernels.")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc = stream_screen(X, STREAM_GRID, config={"tile": STREAM_TILE, "chunk": CHUNK})
    seconds = time.perf_counter() - t0
    launches = instrument.count("kernels.covgram_screen.launches")
    S_dev = sample_covariance(X)
    smax = float(S_dev.abs().max())
    margins = []
    for lam, labels in zip(sc.lambdas, sc.labels):
        dense, margin = dense_partition(S_dev, lam)
        margins.append(margin)
        if margin < MARGIN_RTOL * smax:
            raise AssertionError(f"stream: an |S_ij| lies within {margin} of lam={lam}")
        if not np.array_equal(labels, dense):
            raise AssertionError(f"stream: partition at lam={lam} differs from the dense one")
    log("stream", n=n, p=p, tile=STREAM_TILE, chunk=CHUNK, lambdas=len(sc.lambdas),
        tiles_total=sc.tiles_total, tiles_skipped=sc.tiles_skipped,
        skip_rate=f"{sc.tiles_skipped / max(sc.tiles_total, 1):.4f}",
        edges_emitted=sc.stats[0].edges_emitted, bytes_peak=sc.stats[0].bytes_peak,
        covgram_launches=launches, seconds=f"{seconds:.3f}",
        n_components=json.dumps([st.n_components for st in sc.stats]),
        min_margin=min(margins), partitions_equal_dense=True)
    del S_dev
    torch.cuda.empty_cache()


# ---------------------------------------------------------- phases 11-14


@contextmanager
def record_results(module: str, name: str):
    """``record_calls`` that also keeps each call's result."""
    mod = importlib.import_module(module)
    inner = getattr(mod, name)
    calls: list[tuple[tuple, dict, object]] = []

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(mod, name, recording)
    try:
        yield calls
    finally:
        setattr(mod, name, inner)


@contextmanager
def record_peaks(module: str, name: str):
    """``record_results`` that also measures each call's peak device bytes:
    the most allocated during the call beyond what was allocated when it
    began, plus the bytes of its first argument (the (N, b, b) stack it
    solves, one of the memory model's buffers).  It resets the allocator's
    peak counter at each call."""
    mod = importlib.import_module(module)
    inner = getattr(mod, name)
    calls: list[tuple[tuple, dict, object, int]] = []

    def recording(*args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base + args[0].numel() * args[0].element_size()
        calls.append((args, kwargs, out, peak))
        return out

    setattr(mod, name, recording)
    try:
        yield calls
    finally:
        setattr(mod, name, inner)


@contextmanager
def record_prox_launches(module: str = "repro_torch.joint.admm",
                         name: str = "joint_prox_step"):
    """Keep the inputs of the first, every power-of-two-th and the last call
    of the kernel wrapper ``module.name`` made inside the block (the
    launches of a whole solve would hold gigabytes); yields a dict
    {call index: (args, kwargs)} with the call count under ``"n"``."""
    mod = importlib.import_module(module)
    inner = getattr(mod, name)
    kept: dict = {"n": 0}

    def recording(*args, **kwargs):
        i = kept["n"]
        prev = i - 1
        if prev > 0 and prev & (prev - 1):  # kept only while it was the last
            del kept[prev]
        kept[i] = (args, kwargs)
        kept["n"] = i + 1
        return inner(*args, **kwargs)

    setattr(mod, name, recording)
    try:
        yield kept
    finally:
        setattr(mod, name, inner)


def first_middle_last(kept: dict) -> list[tuple[int, tuple, dict]]:
    """The first, a middle and the last recorded prox launch."""
    idx = sorted(k for k in kept if isinstance(k, int))
    if not idx:
        return []
    mid = min(idx, key=lambda i: abs(i - kept["n"] // 2))
    return [(i, *kept[i]) for i in sorted({idx[0], mid, idx[-1]})]


def hybrid_labels_on_card(Ss_dev: torch.Tensor, lam1: float, lam2: float,
                          penalty: str) -> tuple[np.ndarray, float]:
    """Canonical labels of the hybrid-thresholded union graph, computed here
    on the card from the definitions (group: sum_k soft(|S_k|, lam1)^2 >
    lam2^2; fused: some subset A of the classes with |sum_A S_k| >
    |A| lam1 + |A|(K - |A|) lam2, checked through the sorted prefix sums),
    components by scipy; and the margin min |excess| off the diagonal."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    K, p, _ = Ss_dev.shape
    if penalty == "group":
        soft = (Ss_dev.abs() - lam1).clamp_(min=0.0)
        excess = (soft * soft).sum(dim=0) - lam2 * lam2
        del soft
    else:
        srt = torch.sort(Ss_dev, dim=0).values
        prefix = torch.cat([torch.zeros_like(srt[:1]), torch.cumsum(srt, dim=0)])
        del srt
        excess = torch.full((p, p), -math.inf, dtype=Ss_dev.dtype, device=Ss_dev.device)
        for m in range(1, K + 1):
            top = prefix[K] - prefix[K - m]
            bound = m * lam1 + lam2 * m * (K - m)
            excess = torch.maximum(excess, torch.maximum(top, -prefix[m]) - bound)
        del prefix
    excess.fill_diagonal_(-math.inf)
    ij = torch.nonzero(torch.triu(excess > 0.0, diagonal=1)).cpu().numpy()
    margin = float(excess.abs().min())
    del excess
    G = coo_matrix((np.ones(len(ij)), (ij[:, 0], ij[:, 1])), shape=(p, p))
    _, comp = connected_components(G, directed=False)
    return canonical(comp), margin


def check_joint_solution(Ss: list, res, *, penalty: str) -> float:
    """Cross-component zeros in every class, finite Theta, and the joint KKT
    residual of every component block (host numpy, ``joint_kkt_residual``)
    and of every isolated vertex; returns the worst residual."""
    from repro_torch.core.components import component_lists
    from repro_torch.joint import joint_kkt_residual

    lab = np.asarray(res.labels)
    cross = lab[:, None] != lab[None, :]
    for k in range(len(Ss)):
        if np.any(res.Theta[k][cross] != 0.0):
            raise AssertionError(f"joint: Theta of class {k} is nonzero across components")
    del cross
    if not np.isfinite(res.Theta).all():
        raise AssertionError("joint: Theta has non-finite entries")
    worst = 0.0
    iso = []
    for comp in component_lists(lab):
        if comp.size == 1:
            iso.append(int(comp[0]))
            continue
        ix = np.ix_(comp, comp)
        worst = max(worst, joint_kkt_residual(
            [S[ix] for S in Ss], res.Theta[:, comp[:, None], comp[None, :]],
            res.lam1, res.lam2, penalty=penalty))
    iso = np.asarray(iso, dtype=np.int64)
    for k, S in enumerate(Ss):
        if iso.size:
            worst = max(worst, float(np.abs(
                1.0 / res.Theta[k][iso, iso] - S[iso, iso] - res.lam1).max()))
    smax = max(float(np.abs(S).max()) for S in Ss)
    if not worst <= KKT_RTOL * smax:
        raise AssertionError(f"joint: KKT residual {worst} > {KKT_RTOL}*max|S|")
    return worst


def admm_iteration_split(S, lam1, lam2, args: tuple, *, penalty: str, iters: int) -> dict:
    """One ADMM iteration of a bucket, piece by piece (CUDA events, mean of
    ``reps`` runs each) on a recorded mid-solve state: the batched eigh, the
    reconstruction of Theta, the joint_prox kernel, and the lane
    bookkeeping; plus the host-clock ms per iteration of the whole loop over
    ``iters`` iterations from a cold start of the same bucket."""
    iters = min(iters, 1000)
    from repro_torch.joint.admm import (
        advance_lanes,
        joint_admm_info,
        theta_eigh,
        theta_from_eigh,
    )
    from repro_torch.kernels.joint_prox import joint_prox_step

    theta, U, Z, t = args
    n, K, b, _ = S.shape
    rho = lam1 / t[:, 0]
    reps = 20
    d, Q = theta_eigh(S, Z, U, rho)
    new = joint_prox_step(theta, U, Z, t, penalty=penalty)
    inf = torch.full((n,), math.inf, dtype=S.dtype, device=S.device)
    state = (Z, U, rho, inf, inf, torch.zeros(n, dtype=torch.int32, device=S.device))
    active = torch.ones(n, dtype=torch.bool, device=S.device)
    eps = JOINT_SOLVER_OPTS["tol"] * b * math.sqrt(K)
    out = {
        "eigh_ms": cuda_ms(lambda: theta_eigh(S, Z, U, rho), reps),
        "reconstruct_ms": cuda_ms(lambda: theta_from_eigh(d, Q, rho, S.shape), reps),
        "joint_prox_ms": cuda_ms(lambda: joint_prox_step(theta, U, Z, t, penalty=penalty), reps),
        "lanes_ms": cuda_ms(lambda: advance_lanes(state, new, active, eps, iters), reps),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    joint_admm_info(S, lam1, lam2, penalty=penalty, tol=0.0, max_iter=iters)
    torch.cuda.synchronize()
    out["iteration_wall_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def kernel_device_ms(fn, name: str, reps: int, per_call: int = 1) -> float:
    """Mean device milliseconds per call of the kernels whose names hold
    ``name`` (``per_call`` such launches a call), from ``profile_calls``:
    the mean duration of the events the profiler recorded, times
    ``per_call`` (the profiler may miss some of a window's events, so their
    sum over ``reps`` would undercount); 0.0 where it records none.  Unlike
    a call's CUDA-event time, it leaves out the host's launch cost when the
    host is the slower side."""
    return profile_calls(fn, reps, name)[1] * per_call


def joint_prox_bound_ms(theta: torch.Tensor) -> float:
    """Read theta, u and z_old, write z_new and u_new: 5 n K b^2 itemsize
    bytes."""
    return 5 * theta.numel() * theta.element_size() / HBM_BYTES_PER_S * 1e3


def joint_prox_on_path(launches: list, *, penalty: str, label: str) -> dict:
    """Each recorded joint_prox launch against its plain version on its own
    inputs and its rp2/rd2 against a second call's, bit for bit (raises on
    disagreement, or on a call that is more than its one kernel), and
    CUDA-event, device and host times summed over them."""
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step

    out = dict(n=len(launches), err_z=0.0, err_u=0.0, rel_rp2=0.0, rel_rd2=0.0,
               ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, ms_f32=0.0, host_ms=0.0,
               shapes=[], events={})
    for i, args, kw in launches:
        got = joint_prox_step(*args, **kw)
        want = joint_prox_ref(*args, **kw)
        again = joint_prox_step(*args, **kw)
        if not (torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])):
            raise AssertionError(f"joint_prox {label} launch {i}: rp2/rd2 differ from call to call")
        del again
        # the profiler may miss a few microsecond-short events, never add one
        events, device_ms = profile_calls(lambda: joint_prox_step(*args, **kw), 20,
                                          "joint_prox")
        if len(events) != 1 or "joint_prox" not in next(iter(events)) \
                or not 0.0 < next(iter(events.values())) <= 1.0:
            raise AssertionError(f"joint_prox {label} launch {i}: device events a call {events}")
        out["events"] = events
        a32 = as_f32(args)
        check_joint_prox_f32(joint_prox_step(*a32, **kw), joint_prox_ref(*a32, **kw),
                             f"{label} launch {i} in float32")
        out["ms_f32"] += cuda_ms(lambda: joint_prox_step(*a32, **kw), 20)
        ez = float((got[0] - want[0]).abs().max())
        eu = float((got[1] - want[1]).abs().max())
        rel = [float(((g - w).abs() / w.abs().clamp(min=1e-300)).max())
               for g, w in zip(got[2:], want[2:])]
        if not (ez <= JOINT_PROX_ATOL and eu <= JOINT_PROX_ATOL
                and max(rel) <= JOINT_PROX_RTOL):
            raise AssertionError(
                f"joint_prox {label} launch {i}: |dZ|={ez} |dU|={eu} rel rp2/rd2={rel}")
        out["err_z"] = max(out["err_z"], ez)
        out["err_u"] = max(out["err_u"], eu)
        out["rel_rp2"] = max(out["rel_rp2"], rel[0])
        out["rel_rd2"] = max(out["rel_rd2"], rel[1])
        out["ms"] += cuda_ms(lambda: joint_prox_step(*args, **kw), 20)
        out["device_ms"] += device_ms
        out["host_ms"] += host_ms(lambda: joint_prox_step(*args, **kw), 200)
        out["plain_ms"] += cuda_ms(lambda: joint_prox_ref(*args, **kw), 3)
        out["bound_ms"] += joint_prox_bound_ms(args[0])
        out["shapes"].append([i] + list(args[0].shape))
    return out


def solve_joint_on_card(phase: str, case: str, Ss: list, penalty: str, *,
                        Xs: list | None = None) -> tuple[dict, object, dict, list]:
    """One joint solve through ``joint_glasso`` on the card (from Ss, or from
    Xs when given), counters zeroed just before and read just after; returns
    (launches, result, recorded prox launches, per-bucket ADMM results)."""
    opts = EngineOptions(output="dense", solver_opts=JOINT_SOLVER_OPTS)
    torch.cuda.synchronize()
    for prefix in ("kernels.", "joint.", "router.", "stream."):
        instrument.reset(prefix)
    with record_prox_launches() as kept, \
            record_results("repro_torch.joint.admm", "joint_admm_info") as admm:
        t0 = time.perf_counter()
        if Xs is None:
            res = joint_glasso(Ss, JOINT_LAM1, JOINT_LAM2, penalty=penalty, options=opts)
        else:
            res = joint_glasso(Xs=Xs, lam1=JOINT_LAM1, lam2=JOINT_LAM2, penalty=penalty,
                               stream={"tile": FROM_DATA_TILE, "chunk": CHUNK},
                               options=opts)
        wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    joint_counts = instrument.counts("joint.")
    stream_counts = instrument.counts("stream.")
    iters = [sorted(out[1].tolist()) for _, _, out in admm]
    stages = res.stages()
    log(phase, case=case, K=len(Ss), p=Ss[0].shape[0], penalty=penalty,
        lam1=JOINT_LAM1, lam2=JOINT_LAM2, route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), fallbacks=res.fallbacks,
        joint=json.dumps(joint_counts, sort_keys=True),
        stream=json.dumps(stream_counts, sort_keys=True),
        admm_buckets=json.dumps([[tuple(args[0].shape)[:2], it[0], it[len(it) // 2], it[-1]]
                                 for (args, _, _), it in zip(admm, iters)]),
        wall_s=f"{wall:.3f}", screen_s=f"{stages['screen']:.4f}",
        plan_s=f"{span_seconds(res, 'engine.plan'):.4f}",
        solve_s=f"{stages['solve']:.4f}", assemble_s=f"{stages['assemble']:.4f}")
    if res.fallbacks != 0 or joint_counts.get("joint.fallbacks", 0) != 0:
        raise AssertionError(f"{phase}: {res.fallbacks} fallbacks (expected none)")
    return launches, res, kept, admm


def phase_joint(phase: str, case: tuple, penalty: str, required: tuple) -> tuple:
    """joint_glasso from Ss on the card (one solve), checked against
    the union labels computed here, the route mix, fallbacks, zeros and
    KKT; returns (launches of the first solve, its recorded prox launches)."""
    K_blocks, p1, classes, shared = case
    stack = structured_synthetic(K_blocks, p1, classes=classes, shared_fraction=shared,
                                 seed=1)
    Ss = list(stack)
    S_dev = torch.as_tensor(stack).to(DEV)
    del stack
    labels, margin = hybrid_labels_on_card(S_dev, JOINT_LAM1, JOINT_LAM2, penalty)
    smax = float(S_dev.abs().max())
    del S_dev
    torch.cuda.empty_cache()
    if margin < MARGIN_RTOL * smax:
        raise AssertionError(f"{phase}: a pair's excess lies within {margin} of the rule")
    name = "structured K={} p1={} classes={} shared={}".format(*case)
    launches, res, kept, admm = solve_joint_on_card(phase, name, Ss, penalty)
    if not np.array_equal(res.labels, labels):
        raise AssertionError(f"{phase}: labels differ from the hybrid rule's components")
    missing = [c for c in required if res.route_mix.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"{phase}: route mix {res.route_mix} lacks {missing}")
    kkt = check_joint_solution(Ss, res, penalty=penalty)
    log(phase + "_check", labels_equal_rule=True, margin=margin, kkt=kkt, max_abs_S=smax)
    prox = first_middle_last(kept)
    del res, kept
    for name_ in ("joint_prox", "tree_glasso", "bucket_glasso"):
        if launches.get(f"{name_}.launches", 0) <= 0:
            raise AssertionError(f"{name_} was not launched on the [{phase}] path")
    if sum(len(out[1]) for _, _, out in admm) == 0:
        raise AssertionError(f"{phase}: no joint ADMM bucket ran")
    # the per-iteration split: the bucket of the middle recorded launch
    i_mid, mid_args, _ = prox[len(prox) // 2]
    S_b, l1, l2 = next(c[0][:3] for c in admm if c[0][0].shape == mid_args[0].shape)
    iters = int(next(c[2][1].max() for c in admm if c[0][0].shape == mid_args[0].shape))
    split = admm_iteration_split(S_b, l1, l2, mid_args[:4], penalty=penalty, iters=iters)
    log(phase + "_split", bucket=list(S_b.shape), launch=i_mid, iterations=iters,
        **{k: f"{v:.4f}" for k, v in split.items()})
    del admm
    return launches, prox


def phase_joint_from_data() -> dict:
    """joint_glasso(Xs=...) on the card, K classes of the from-data workload:
    streamed labels equal to the port's dense joint screen on each class's
    ``sample_covariance`` and to the rule computed here, zero fallbacks,
    zeros and KKT; returns the launches of the first solve, the Xs and
    their covariances (for [serve_glasso])."""
    from repro_torch.joint import joint_thresholded_components

    Xs = [workload(FROM_DATA_P, load=0.9, noise=0.44, seed=k) for k in range(JOINT_FROM_DATA_K)]
    S_devs = [sample_covariance(X) for X in Xs]
    smax = max(float(S.abs().max()) for S in S_devs)
    margins = [dense_partition(S, JOINT_LAM1)[1] for S in S_devs]
    stack = torch.stack(S_devs)
    del S_devs
    rule_labels, margin = hybrid_labels_on_card(stack, JOINT_LAM1, JOINT_LAM2, "group")
    Ss = list(stack.cpu().numpy())
    del stack
    torch.cuda.empty_cache()
    if min(margins + [margin]) < MARGIN_RTOL * smax:
        raise AssertionError("joint_from_data: a value lies within the margin of the rule")
    dense_labels, _ = joint_thresholded_components(Ss, JOINT_LAM1, JOINT_LAM2, penalty="group")
    if not np.array_equal(dense_labels, rule_labels):
        raise AssertionError("joint_from_data: the dense joint screen differs from the rule")
    case = f"workload p={FROM_DATA_P} n={N_ROWS} K={JOINT_FROM_DATA_K} tile={FROM_DATA_TILE}"
    first = None
    for run in ("first", "repeat"):
        launches, res, _, _ = solve_joint_on_card("joint_from_data", f"{case} ({run})", Ss,
                                                  "group", Xs=Xs)
        if not np.array_equal(res.labels, dense_labels):
            raise AssertionError("joint_from_data: streamed labels differ from the dense screen")
        kkt = check_joint_solution(Ss, res, penalty="group")
        log("joint_from_data_check", case=run, labels_equal_dense=True, margin=min(margins),
            rule_margin=margin, kkt=kkt, max_abs_S=smax,
            candidate_pairs=res.screen.candidate_pairs, tiles_total=res.screen.tiles_total,
            tiles_skipped=res.screen.tiles_skipped, n_edges=res.screen.n_edges)
        first = first or launches
    if first.get("covgram_screen.launches", 0) <= 0:
        raise AssertionError("covgram_screen was not launched on the [joint_from_data] path")
    return dict(launches=first, Xs=Xs, Ss=Ss)


# ---------------------------------------------------------- phases 15-19


def phase_solver(solver: str, S: np.ndarray, lam: float, bcd_res) -> tuple[dict, dict]:
    """glasso(S, lam, solver=...) on the main case, first and repeat: the
    checks of [main] (labels against scipy, zeros, KKT), every rung of the
    route mix, Theta against the bcd solve of the same run; returns the
    launches of the first solve and its recorded kernel launches."""
    module, name, kernel = SOLVER_KERNELS[solver]
    opts = EngineOptions(solver=solver, solver_opts=SOLVER_OPTS)
    case = "structured K={} p1={}".format(*MAIN_CASE)
    scale = float(np.abs(bcd_res.Theta).max())
    first = None
    for run in ("first", "repeat"):
        with record_prox_launches(module, name) as kept:
            launches, res = solve_on_card(f"{case} solver={solver} ({run})", S, lam,
                                          phase=solver, options=opts)
        missing = [c for c in MAIN_ROUTES if res.route_mix.get(c, 0) <= 0]
        if missing:
            raise AssertionError(f"[{solver}] route mix {res.route_mix} lacks {missing}")
        if res.route_mix != bcd_res.route_mix or not np.array_equal(res.labels, bcd_res.labels):
            raise AssertionError(f"[{solver}] plan differs from the bcd solve's")
        diff = float(np.abs(res.Theta - bcd_res.Theta).max())
        if not diff <= THETA_VS_BCD_RTOL * scale:
            raise AssertionError(
                f"[{solver}] max|Theta - Theta_bcd| = {diff} > {THETA_VS_BCD_RTOL}*{scale}")
        log(solver + "_check", case=run, theta_vs_bcd=diff, max_abs_theta=scale,
            fallbacks=json.dumps(instrument.tail_counts("router.fallback."), sort_keys=True),
            kernel_calls=kept["n"])
        first = first or (launches, kept)
    launches, kept = first
    if launches.get(f"{kernel}.launches", 0) <= 0:
        raise AssertionError(f"{kernel} was not launched on the [{solver}] path")
    if kept["n"] != launches[f"{kernel}.launches"]:
        raise AssertionError(
            f"[{solver}] {kept['n']} {kernel} calls recorded, {launches} launched")
    return launches, kept


def elementwise_bound_ms(x: torch.Tensor, passes: int) -> float:
    """``passes`` arrays of x's size moved once each, at the HBM rate."""
    return passes * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3


def prox_l1_on_path(kept: dict) -> dict:
    """The first, a middle and the last prox_l1 launch of the [pg] solve:
    kernel against plain version (bit-equal), CUDA-event and device times,
    the plain version, and the nearest PyTorch expression
    softshrink(theta - t*grad, t*lam) with the first lane's t as a scalar."""
    from repro_torch.kernels.prox_l1 import prox_step, prox_step_ref

    out = dict(n=0, err=0.0, ms=0.0, device_ms=0.0, host_ms=0.0, plain_ms=0.0,
               library_ms=0.0, bound_ms=0.0, ms_f32=0.0, shapes=[], events={})
    for i, args, kw in first_middle_last(kept):
        theta, grad, t, lam = args
        got, want = prox_step(*args, **kw), prox_step_ref(*args, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"prox_l1 launch {i} differs from its plain version")
        a32 = as_f32(args)
        if not torch.equal(prox_step(*a32, **kw), prox_step_ref(*a32, **kw)):
            raise AssertionError(f"prox_l1 launch {i} in float32 differs from its plain version")
        out["ms_f32"] += cuda_ms(lambda: prox_step(*a32, **kw), 20)
        t0 = float(t[0]) if isinstance(t, torch.Tensor) and t.ndim else float(t)
        l0 = float(lam[0]) if isinstance(lam, torch.Tensor) and lam.ndim else float(lam)
        out["n"] += 1
        out["err"] = max(out["err"], float((got - want).abs().max()))
        out["ms"] += cuda_ms(lambda: prox_step(*args, **kw), 20)
        out["device_ms"] += kernel_device_ms(lambda: prox_step(*args, **kw), "prox_l1", 20)
        out["host_ms"] += host_ms(lambda: prox_step(*args, **kw), 20)
        out["events"] = device_events(lambda: prox_step(*args, **kw), 10)
        if len(out["events"]) != 1 or "prox_l1" not in next(iter(out["events"])):
            raise AssertionError(f"prox_l1 launch {i}: device events {out['events']}")
        out["plain_ms"] += cuda_ms(lambda: prox_step_ref(*args, **kw), 5)
        out["library_ms"] += cuda_ms(
            lambda: torch.nn.functional.softshrink(theta - t0 * grad, t0 * l0), 20)
        out["bound_ms"] += elementwise_bound_ms(theta, 3)
        out["shapes"].append([i] + list(theta.shape))
    return out


def log_prox_l1(pl: dict) -> None:
    """The [prox_l1] line of the [pg] solve's checked launches (times
    summed over them; ``ms_a_launch`` the CUDA-event time of one)."""
    log("prox_l1", path="pg", launches_timed=pl["n"], shapes=json.dumps(pl["shapes"]),
        max_abs_err=pl["err"], ms=f"{pl['ms']:.4f}", device_ms=f"{pl['device_ms']:.4f}",
        host_ms=f"{pl['host_ms']:.4f}", ms_a_launch=f"{pl['ms'] / max(pl['n'], 1):.4f}",
        plain_ms=f"{pl['plain_ms']:.4f}", softshrink_expression_ms=f"{pl['library_ms']:.4f}",
        bound_ms=f"{pl['bound_ms']:.6f}", ms_f32=f"{pl['ms_f32']:.4f}",
        device_events_per_call=json.dumps(pl["events"]))


def device_events(fn, reps: int) -> dict[str, float]:
    """The profiler's device events of ``fn()`` by name, each with its count
    a call (``profile_calls``)."""
    return profile_calls(fn, reps)[0]


def shard_prox_on_path(kept: dict) -> dict:
    """The first, a middle and the last shard_prox launch of a solve: Z' and
    U' bit-equal to the plain version, rp2/rd2 within SHARD_PROX_RTOL and
    bit-equal to a second call's; one device event a call (the kernel, no
    fill or copy beside it); CUDA-event and device times, the plain
    version, and the nearest PyTorch expression softshrink(x_new + u, t)
    (Z' only, no residuals)."""
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

    out = dict(n=0, err=0.0, rel_sums=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               library_ms=0.0, bound_ms=0.0, ms_f32=0.0, host_ms=0.0, library_host_ms=0.0,
               shapes=[], events={})
    for i, args, kw in first_middle_last(kept):
        x, u, _, t = args
        got, want = fused_prox_residual(*args, **kw), fused_prox_ref(*args, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"shard_prox launch {i}: Z'/U' differ from the plain version")
        again = fused_prox_residual(*args, **kw)
        if not (torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])):
            raise AssertionError(f"shard_prox launch {i}: rp2/rd2 differ from call to call")
        # the profiler may miss a few microsecond-short events, never add one
        events = device_events(lambda: fused_prox_residual(*args, **kw), 20)
        if len(events) != 1 or "shard_prox" not in next(iter(events)) \
                or not 0.0 < next(iter(events.values())) <= 1.0:
            raise AssertionError(f"shard_prox launch {i}: device events a call {events}")
        out["events"] = events
        a32 = as_f32(args)
        check_shard_prox_f32(fused_prox_residual(*a32, **kw), fused_prox_ref(*a32, **kw),
                             f"launch {i} in float32")
        out["ms_f32"] += cuda_ms(lambda: fused_prox_residual(*a32, **kw), 20)
        rel = max(float(((g - w).abs() / w.abs().clamp(min=1e-300)).max())
                  for g, w in zip(got[2:], want[2:]))
        if not rel <= SHARD_PROX_RTOL:
            raise AssertionError(f"shard_prox launch {i}: rp2/rd2 relative error {rel}")
        t0 = float(t.reshape(-1)[0]) if isinstance(t, torch.Tensor) else float(t)
        out["n"] += 1
        out["err"] = max(out["err"], float((got[0] - want[0]).abs().max()),
                         float((got[1] - want[1]).abs().max()))
        out["rel_sums"] = max(out["rel_sums"], rel)
        out["ms"] += cuda_ms(lambda: fused_prox_residual(*args, **kw), 20)
        out["device_ms"] += kernel_device_ms(lambda: fused_prox_residual(*args, **kw),
                                             "shard_prox", 20)
        out["plain_ms"] += cuda_ms(lambda: fused_prox_ref(*args, **kw), 5)
        out["library_ms"] += cuda_ms(lambda: torch.nn.functional.softshrink(x + u, t0), 20)
        out["host_ms"] += host_ms(lambda: fused_prox_residual(*args, **kw), 200)
        out["library_host_ms"] += host_ms(
            lambda: torch.nn.functional.softshrink(x + u, t0), 200)
        out["bound_ms"] += elementwise_bound_ms(x, 5)
        out["shapes"].append([i] + list(x.shape))
    return out


def log_shard_prox(path: str, sp: dict, launches: dict) -> None:
    """The [shard_prox] line of one path's checked and timed launches."""
    log("shard_prox", path=path, path_launches=launches["shard_prox.launches"],
        launches_timed=sp["n"], shapes=json.dumps(sp["shapes"]), max_abs_err=sp["err"],
        rel_err_sums=sp["rel_sums"], ms=f"{sp['ms']:.4f}", device_ms=f"{sp['device_ms']:.4f}",
        plain_ms=f"{sp['plain_ms']:.4f}", softshrink_expression_ms=f"{sp['library_ms']:.4f}",
        bound_ms=f"{sp['bound_ms']:.6f}", ms_f32=f"{sp['ms_f32']:.4f}",
        ms_over_expression=f"{sp['ms'] / sp['library_ms']:.3f}",
        host_ms=f"{sp['host_ms']:.4f}", expression_host_ms=f"{sp['library_host_ms']:.4f}",
        device_events_per_call=json.dumps(sp["events"]))


def giant_workload(p: int, seed: int = 0) -> np.ndarray:
    """``benchmarks/bench_giant.py``'s ``_workload``: one giant
    factor-coupled component plus a fringe of planted pairs and isolated
    vertices (n = 320 rows)."""
    rng = np.random.default_rng(seed)
    X = 0.8 * rng.standard_normal((GIANT_N, p))
    giant = int(0.8 * p)
    f = rng.standard_normal((GIANT_N, 3))
    load = 0.5 + 0.2 * rng.random(giant)
    X[:, :giant] += f[:, rng.integers(0, 3, giant)] * load
    for k in range(giant, p - 1, 6):
        X[:, k + 1] += 0.9 * X[:, k]
    S = np.cov(X, rowvar=False, bias=True)
    return 0.5 * (S + S.T)


def sharded_iteration_split(S_pad: torch.Tensor, args: tuple, lam: float, *, ns_steps: float,
                            pow_steps: int = 10) -> dict:
    """One outer iteration of the sharded ADMM, piece by piece (CUDA events)
    on a recorded mid-solve state: the power iteration (pow_steps + 1
    matvecs), M^2 + 4 rho I, one Newton-Schulz step (three (bp, bp)
    products and the error's max), the shard_prox launch, and one host read
    of a device flag (host clock); and the model of a whole iteration with
    the solve's mean NS steps."""
    from repro_torch.kernels.shard_prox import fused_prox_residual

    Theta, U, Z, t = args
    bp = S_pad.shape[0]
    rho = lam / t
    M = rho * (Z - U) - S_pad
    eye = torch.eye(bp, dtype=S_pad.dtype, device=S_pad.device)
    v0 = torch.ones(bp, dtype=S_pad.dtype, device=S_pad.device) / math.sqrt(bp)

    def power():
        v = v0
        for _ in range(pow_steps + 1):
            u = M @ v
            v = u / (torch.linalg.vector_norm(u) + 1e-30)
        return v

    A = M @ M + 4.0 * rho * eye
    Y = A / float(A.abs().max())

    def ns_step():
        T = 0.5 * (3.0 * eye - eye @ Y)
        err = torch.max(torch.abs(T - eye))
        return Y @ T, T @ eye, err

    reps = 10
    out = {
        "power_ms": cuda_ms(power, reps),
        "m2_ms": cuda_ms(lambda: M @ M + 4.0 * rho * eye, reps),
        "ns_step_ms": cuda_ms(ns_step, reps),
        "prox_ms": cuda_ms(lambda: fused_prox_residual(*args), reps),
    }
    flag = torch.zeros((), device=S_pad.device) > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bool(flag)
    out["host_read_ms"] = (time.perf_counter() - t0) * 1e3 / 100
    out["model_iteration_ms"] = (out["power_ms"] + out["m2_ms"] + out["prox_ms"]
                                 + ns_steps * (out["ns_step_ms"] + out["host_read_ms"])
                                 + out["host_read_ms"])
    del M, A, Y
    return out


def oversize_budget() -> dict:
    """oversize_budget_mb="auto" on the card: the budget (free bytes plus
    what the caching allocator reserves) and the threshold derived from it
    by the reference's model of SINGLE_DEVICE_BUFFERS float64 (b, b)
    buffers, checked to lie within the card's memory."""
    torch.cuda.empty_cache()
    budget_mb = device_memory_budget_mb(DEV)
    threshold = oversize_threshold(budget_mb)
    need = SINGLE_DEVICE_BUFFERS * 8 * threshold * threshold
    total = torch.cuda.get_device_properties(DEV).total_memory
    if not (need <= budget_mb * 2**20 <= total):
        raise AssertionError(f"[oversize] budget {budget_mb} MB, need {need}, total {total}")
    return dict(budget_mb=budget_mb, total_mb=total / 2**20, threshold=threshold,
                model_bytes=need)


def eigh_workspace_bytes(b: int) -> int:
    """Device bytes torch.linalg.eigh allocates beyond its operand and
    eigenvalues for one (1, b, b) float64 matrix, run in place as the admm
    solve runs it: the library's own workspace."""
    a = torch.rand((1, b, b), dtype=torch.float64, device=DEV)
    a = (a + a.mT).mT  # symmetric, column-major
    d = torch.empty((1, b), dtype=torch.float64, device=DEV)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.linalg.eigh(a, out=(d, a))
    torch.cuda.synchronize()
    ws = torch.cuda.max_memory_allocated() - base
    del a, d
    return ws


def budget_fit(budget: dict, peak_bytes: int, padded: int, with_check_bytes: int,
               eigh_ws: int) -> dict:
    """Does the dense solve fit in the budget at the derived threshold?
    The admm solve's measured peak bytes per padded entry (its block stack,
    Z/U, the eigh buffer and eigh's workspace, or Q diag(.) and the
    product) against the memory model's SINGLE_DEVICE_BUFFERS * 8, and the
    largest b whose scaled peak fits the budget.  Its floor: the larger of
    four (b, b) buffers plus eigh's own workspace (``eigh_ws``, measured on
    its own) and six buffers.  ``with_check_bytes`` is the peak of the whole
    checked solve (the engine run and the KKT check of the full Theta on
    the card, the scope measured before), logged
    beside it."""
    per_entry = peak_bytes / padded ** 2
    model = SINGLE_DEVICE_BUFFERS * 8
    floor = max(4 * 8 * padded ** 2 + eigh_ws, 6 * 8 * padded ** 2)
    fit_b = int(math.sqrt(budget["budget_mb"] * 2**20 / per_entry))
    return dict(budget_mb=f"{budget['budget_mb']:.1f}", total_mb=f"{budget['total_mb']:.1f}",
                threshold=budget["threshold"], model_bytes=budget["model_bytes"],
                model_bytes_per_entry=model,
                dense_admm_peak_bytes=peak_bytes, dense_admm_padded=padded,
                dense_admm_bytes_per_entry=f"{per_entry:.2f}", dense_admm_fit_b=fit_b,
                eigh_workspace_bytes_per_entry=f"{eigh_ws / padded ** 2:.2f}",
                floor_bytes_per_entry=f"{floor / padded ** 2:.2f}",
                at_floor=peak_bytes <= 1.01 * floor,
                gap_bytes_per_entry=f"{per_entry - model:.2f}",
                with_check_bytes_per_entry=f"{with_check_bytes / padded ** 2:.2f}",
                threshold_fits_dense_solve=per_entry <= model)


def phase_oversize() -> tuple[dict, dict]:
    """The giant-block route on the card: glasso(S, lam, solver="admm",
    oversize_threshold=...) on bench_giant's workload, checked as [main] is,
    plus one sharded dispatch, no fallback, the in-place KKT within
    route_check_tol*max(1, max|S|) and Theta against the dense
    single-device admm solve of the same S (bench_giant's acceptance);
    returns the launches of the solve and its recorded shard_prox
    launches."""
    S = giant_workload(GIANT_P)
    lam = GIANT_LAM
    smax = float(np.abs(S).max())
    sizes = np.unique(components_from_covariance_host(S, lam), return_counts=True)[1]
    b_giant = int(sizes.max())
    if b_giant <= GIANT_THRESHOLD or (sizes > GIANT_THRESHOLD).sum() != 1:
        raise AssertionError(f"[oversize] expected one component above {GIANT_THRESHOLD}, "
                             f"got sizes {sorted(sizes)[-3:]}")
    budget = oversize_budget()
    opts = EngineOptions(solver="admm", oversize_threshold=GIANT_THRESHOLD,
                         solver_opts=SOLVER_OPTS)
    case = f"bench_giant p={GIANT_P} n={GIANT_N} b={b_giant}"
    instrument.reset("solver.oversize.")
    instrument.reset("router.")
    torch.cuda.reset_peak_memory_stats()
    sharded = "repro_torch.core.solvers.sharded"
    with record_prox_launches(sharded, "fused_prox_residual") as kept, \
            record_results(sharded, "glasso_sharded") as solves:
        launches, res = solve_on_card(case, S, lam, phase="oversize", options=opts)
    peak = torch.cuda.max_memory_allocated()
    counters = instrument.counts("solver.oversize.")
    fallbacks = instrument.tail_counts("router.fallback.")
    if res.route_mix.get("oversize", 0) != 1 or len(solves) != 1:
        raise AssertionError(
            f"[oversize] route mix {res.route_mix}: expected one oversize block")
    if res.oversize.get("dispatched") != 1 or res.oversize.get("fallbacks") != 0:
        raise AssertionError(f"[oversize] {res.oversize}: expected 1 dispatch, 0 fallbacks")
    (S_shards, *_), _, sol = solves[0]
    (S_pad,) = S_shards  # one row shard on one card
    kkt_bound = ROUTE_CHECK_TOL * max(1.0, sol.s_max)
    if not sol.kkt_residual <= kkt_bound:
        raise AssertionError(f"[oversize] in-place KKT {sol.kkt_residual} > {kkt_bound}")
    if kept["n"] != sol.iters or launches.get("shard_prox.launches", 0) < sol.iters:
        raise AssertionError(f"[oversize] {launches} launches for {sol.iters} iterations")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with record_peaks("repro_torch.core.solvers.admm", "glasso_admm_info") as dense_calls:
        _, dense = solve_on_card(case + " dense admm", S, lam, phase="oversize_dense",
                                 options=EngineOptions(solver="admm", solver_opts=ORACLE_OPTS))
    with_check_peak = torch.cuda.max_memory_allocated() - base
    diff = float(np.abs(res.Theta - dense.Theta).max())
    theta_bound = ROUTE_CHECK_TOL * max(1.0, smax)
    if not diff <= theta_bound:
        raise AssertionError(f"[oversize] max|Theta - Theta_dense| = {diff} > {theta_bound}")
    dense_iters = [int(c[2][1].max()) for c in dense_calls if c[0][0].shape[-1] >= b_giant]
    log("oversize_check", b=sol.b, padded=sol.padded, iters=sol.iters,
        inner_iters=sol.inner_iters, retries=sol.retries, rho=sol.rho,
        kkt_inplace=sol.kkt_residual, kkt_bound=kkt_bound, s_max=sol.s_max,
        theta_vs_dense=diff, theta_bound=theta_bound, dense_iters=json.dumps(dense_iters),
        oversize=json.dumps(res.oversize, sort_keys=True),
        counters=json.dumps(counters, sort_keys=True),
        fallbacks=json.dumps(fallbacks, sort_keys=True),
        device_bytes=sol.device_bytes, max_memory_allocated=peak,
        solve_s_per_iteration=f"{res.stages()['solve'] / sol.iters:.6f}")
    (args, _, _, dense_peak), = (c for c in dense_calls if c[0][0].shape[-1] >= b_giant)
    padded = args[0].shape[-1]
    fit = budget_fit(budget, dense_peak, padded, with_check_peak, eigh_workspace_bytes(padded))
    log("oversize_budget", **fit)
    # the solve holds nothing beyond its floor; whether that floor fits the
    # model's 64 bytes an entry is logged (threshold_fits_dense_solve), and
    # PERF.md states the gap
    if not fit["at_floor"]:
        raise AssertionError(
            f"[oversize_budget] the dense admm solve peaks at {fit['dense_admm_bytes_per_entry']} "
            f"bytes an entry, above its floor {fit['floor_bytes_per_entry']}")
    del args
    _, mid_args, _ = first_middle_last(kept)[len(first_middle_last(kept)) // 2]
    split = sharded_iteration_split(S_pad, mid_args, lam,
                                    ns_steps=sol.inner_iters / max(sol.iters, 1))
    log("oversize_split", bp=S_pad.shape[0],
        ns_steps_per_iteration=f"{sol.inner_iters / sol.iters:.2f}",
        **{k: f"{v:.4f}" for k, v in split.items()})
    del solves, dense_calls, S_pad, S_shards, mid_args
    torch.cuda.empty_cache()
    comp = max(component_lists(components_from_covariance_host(S, lam)), key=len)
    giant = dict(block=S[np.ix_(comp, comp)], lam=lam, theta=sol.Theta)
    return launches, kept, giant


def row_slab_case(call: tuple) -> dict:
    """One recorded row-slab threshold_cc launch of the sharded screen (a
    shard past row 0): the kernel against its plain version on the same
    slab, and both timed beside the slab's bound (the slab read once)."""
    (S_rows, labels, lam, row0), _ = call
    got = labelprop_rows(S_rows, labels, lam, row0)
    want = labelprop_rows_ref(S_rows, labels, lam, row0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"[multidevice] the row-slab step at row0={row0} differs from plain")
    rows, pp = S_rows.shape
    return dict(shape=[rows, pp], row0=row0, max_abs_err=0.0,
                ms=cuda_ms(lambda: labelprop_rows(S_rows, labels, lam, row0), 10),
                plain_ms=cuda_ms(lambda: labelprop_rows_ref(S_rows, labels, lam, row0), 2),
                bound_ms=rows * pp * S_rows.element_size() / HBM_BYTES_PER_S * 1e3)


def phase_multidevice(large: dict, giant: dict, S_main: np.ndarray, lam_main: float,
                      main_res) -> dict:
    """The paper pillar over a mesh of MULTI_D devices, here MULTI_D row
    shards on the one card (``[cuda:0] * 4``): every shard's kernels run
    there and every copy between shards is a device copy; NVLink between
    cards is not measured.

    1. screen: [large_scale]'s R (p = 16000, float64, four slabs of 512 MB)
       through ``"shard_map"`` at its capacity lambda: labels equal to the
       ``"pallas"`` backend's, MULTI_D row-slab launches a round, ms
       against the one-device screen; one row-slab launch past row 0 held
       to its plain version and timed beside its bound;
    2. oversize: [oversize]'s giant block at d = MULTI_D and at d = 1,
       GIANT_MD_ITERS outer iterations each from the same cold start:
       padded to ``sharded_pad_size(b, d)``, the d = MULTI_D iterate within
       1e-6 max|Theta| of the d = 1 iterate, MULTI_D shard_prox launches an
       outer iteration, the first, a middle and the last of them on their
       (bp/d, bp) shards held to the plain version;
    3. buckets: [main]'s p = 6000 solve through ``Engine(devices=mesh)``:
       Theta bit-equal to the one-device solve, its buckets LPT-placed over
       all MULTI_D indices.
    Launch counters are zeroed just before each case and read just after."""
    mesh = [DEV] * MULTI_D
    out = {}

    # 1. the row-sharded screen
    R, lam = large["R"], large["lam"]
    torch.cuda.synchronize()
    instrument.reset("kernels.")
    instrument.reset("screen.")
    with record_calls("repro_torch.kernels.threshold_cc.ops", "labelprop_rows") as slabs:
        t0 = time.perf_counter()
        labels, stats = thresholded_components(R, lam, backend="shard_map", mesh=mesh)
        t_shard = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    rounds = instrument.count("screen.labelprop_rounds")
    n_slab = launches.get("threshold_cc.launches", 0)
    if n_slab != MULTI_D * rounds or len(slabs) != n_slab:
        raise AssertionError(f"[multidevice] {n_slab} row-slab launches for {rounds} rounds")
    if not np.array_equal(labels, large["labels"]):
        raise AssertionError("[multidevice] the shard_map screen's labels differ from pallas'")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thresholded_components(R, lam, backend="pallas", device=DEV)
    t_one = time.perf_counter() - t0
    slab = row_slab_case(slabs[-1])
    del slabs
    torch.cuda.empty_cache()
    log("multidevice", case="screen", d=MULTI_D, p=R.shape[0], lam=f"{lam:.6g}",
        rounds=rounds, row_slab_launches=n_slab, n_components=stats.n_components,
        n_edges=stats.n_edges, labels_equal_pallas=True,
        ms=f"{t_shard * 1e3:.1f}", one_device_ms=f"{t_one * 1e3:.1f}",
        slab=json.dumps(slab["shape"]), slab_row0=slab["row0"], slab_ms=f"{slab['ms']:.4f}",
        slab_plain_ms=f"{slab['plain_ms']:.4f}", slab_bound_ms=f"{slab['bound_ms']:.4f}")
    out["screen"] = dict(launches=n_slab, rounds=rounds, **slab)

    # 2. the giant block at d shards against d = 1, GIANT_MD_ITERS outer
    # iterations each from the same cold start
    B, theta1 = giant["block"], giant["theta"]
    b, lam_g = B.shape[0], giant["lam"]
    t0 = time.perf_counter()
    ref = glasso_sharded(B, lam_g, mesh=[DEV], max_iter=GIANT_MD_ITERS)
    d1_s = time.perf_counter() - t0
    theta_bound = 1e-6 * float(np.abs(ref.Theta).max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instrument.reset("kernels.")
    with record_prox_launches("repro_torch.core.solvers.sharded", "fused_prox_residual") as kept:
        t0 = time.perf_counter()
        sol = glasso_sharded(B, lam_g, mesh=mesh, max_iter=GIANT_MD_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    peak = torch.cuda.max_memory_allocated()
    if (sol.padded, sol.n_shards) != (sharded_pad_size(b, MULTI_D), MULTI_D):
        raise AssertionError(f"[multidevice] padded {sol.padded} on {sol.n_shards} shards")
    if not sol.iters == ref.iters == GIANT_MD_ITERS:
        raise AssertionError(f"[multidevice] {sol.iters} / {ref.iters} outer iterations, "
                             f"expected {GIANT_MD_ITERS}")
    diff = float(np.abs(sol.Theta - ref.Theta).max())
    if not diff <= theta_bound:
        raise AssertionError(f"[multidevice] max|Theta_d - Theta_1| = {diff} > {theta_bound}")
    n_prox = launches.get("shard_prox.launches", 0)
    if n_prox != MULTI_D * sol.iters or kept["n"] != n_prox:
        raise AssertionError(f"[multidevice] {launches} for {sol.iters} outer iterations")
    sp = shard_prox_on_path(kept)
    if {tuple(shape[1:]) for shape in sp["shapes"]} != {(sol.padded // MULTI_D, sol.padded)}:
        raise AssertionError(f"[multidevice] shard_prox checked on shapes {sp['shapes']}")
    del kept
    torch.cuda.empty_cache()
    log("multidevice", case="oversize", d=MULTI_D, b=b, padded=sol.padded,
        padded_d1=ref.padded, start="cold", iters=sol.iters, iters_d1=ref.iters,
        inner_iters=sol.inner_iters, inner_iters_d1=ref.inner_iters, retries=sol.retries,
        shard_prox_launches=n_prox, theta_vs_d1=diff, theta_bound=theta_bound,
        gap_to_solution=float(np.abs(sol.Theta - theta1).max()),
        kkt_inplace=sol.kkt_residual, device_bytes=sol.device_bytes,
        max_memory_allocated=peak, wall_s=f"{wall:.3f}", d1_s=f"{d1_s:.3f}",
        s_per_iter=f"{wall / max(sol.iters, 1):.5f}",
        s_per_iter_d1=f"{d1_s / max(ref.iters, 1):.5f}")
    log_shard_prox("multidevice", sp, launches)
    out["oversize"] = dict(
        launches=n_prox, iters=sol.iters, launches_checked=sp["n"], shapes=sp["shapes"],
        max_abs_err=sp["err"], rel_err_sums=sp["rel_sums"], ms=sp["ms"],
        plain_ms=sp["plain_ms"], bound_ms=sp["bound_ms"], library_ms=sp["library_ms"])

    # 3. the buckets placed over the mesh
    placements: list = []
    place = BucketExecutor._place

    def recording(self, buckets, priorities=None):
        placed = place(self, buckets, priorities)
        placements.append(placed)
        return placed

    torch.cuda.synchronize()
    instrument.reset("kernels.")
    BucketExecutor._place = recording
    try:
        t0 = time.perf_counter()
        res = Engine(options=EngineOptions(), devices=mesh).run(S_main, lam_main)
        wall = time.perf_counter() - t0
    finally:
        BucketExecutor._place = place
    launches = instrument.tail_counts("kernels.")
    used = sorted({w for w in placements[0] if w is not None}) if placements else []
    if used != list(range(MULTI_D)):
        raise AssertionError(f"[multidevice] buckets placed on {used}")
    if not (np.array_equal(res.labels, main_res.labels)
            and np.array_equal(res.Theta, main_res.Theta)):
        raise AssertionError("[multidevice] Engine(devices=mesh) differs from one device")
    log("multidevice", case="buckets", d=MULTI_D, p=S_main.shape[0],
        buckets=len(placements[0]), placed=json.dumps(placements[0]),
        route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), theta_bits_equal=True,
        sha256=sha(torch.as_tensor(res.Theta)), wall_s=f"{wall:.3f}")
    out["buckets"] = dict(launches=launches)
    return out


# ---------------------------------------------------------- phases 20-24


def as_f32(args: tuple) -> tuple:
    """A recorded launch's arguments with every floating tensor as float32:
    the float32 instance timed and checked on the same shapes."""
    return tuple(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


def check_shard_prox_f32(got, want, label: str) -> None:
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"shard_prox {label}: Z'/U' differ from the plain version")
    rel = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
              for g, w in zip(got[2:], want[2:]))
    if not rel <= F32_SUM_RTOL:
        raise AssertionError(f"shard_prox {label}: rp2/rd2 relative error {rel}")


def check_joint_prox_f32(got, want, label: str) -> float:
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    rel = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
              for g, w in zip(got[2:], want[2:]))
    if not (err <= F32_JOINT_ATOL and rel <= F32_SUM_RTOL):
        raise AssertionError(f"joint_prox {label}: |dZ|,|dU| {err}, rel rp2/rd2 {rel}")
    return err


def gram_bound(n: int, p: int, itemsize: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one centered Gram: X read once and the
    float32 S written once; S is symmetric, so the function needs the
    n p (p + 1) flops of one triangle, at the FP32 rate outside the tensor
    cores."""
    t_bytes = (n * p * itemsize + 4 * p * p) / HBM_BYTES_PER_S * 1e3
    t_ops = gram_flops(n, p) / FP32_FLOPS_PER_S * 1e3
    return t_bytes, t_ops


def gram_flops(n: int, p: int) -> float:
    """Flops of one triangle of a (p, p) Gram over n rows: n p (p + 1)."""
    return float(n) * p * (p + 1)


def phase_covgram() -> dict:
    """The covgram kernel against its plain version at the pipeline's shape,
    on bf16 input and at a ragged shape; CUDA-event times beside the bound,
    the plain version and torch.matmul of the centered X (TF32 off).
    Returns the pipeline shape's numbers and the largest error of the
    three."""
    from repro_torch.kernels.covgram import covgram, covgram_ref

    out = {}
    worst = 0.0
    for label, n, p, dtype in COVGRAM_CASES:
        X = microarray_like(n, p, seed=LARGE_SEED)
        x = torch.as_tensor(X, dtype=torch.float32).to(DEV).to(dtype)
        got, want = covgram(x), covgram_ref(x)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        tol = n * EPS32 * scale
        if not err <= tol:
            raise AssertionError(f"covgram {label}: max|diff| {err} > n eps max|S| = {tol}")
        if not torch.equal(got, got.T):
            raise AssertionError(f"covgram {label}: S is not symmetric")
        digest = sha(got)
        del got, want
        worst = max(worst, err)
        ms = cuda_ms(lambda: covgram(x), 10)
        events, device_ms = profile_calls(lambda: covgram(x), 5, name="covgram")
        issue_ms = host_ms(lambda: covgram(x), 10)
        plain_ms = cuda_ms(lambda: covgram_ref(x), 5)
        xf = x.float()
        xc = xf - xf.mean(dim=0, keepdim=True)
        library_ms = cuda_ms(lambda: torch.matmul(xc.T, xc), 10)
        del xf, xc
        t_bytes, t_ops = gram_bound(n, p, x.element_size())
        bound = max(t_bytes, t_ops)
        log("covgram", case=label, n=n, p=p, dtype=str(dtype).removeprefix("torch."),
            max_abs_err=err, tol=tol, max_abs_S=scale, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bytes_ms=f"{t_bytes:.4f}", ops_ms=f"{t_ops:.4f}", bound_ms=f"{bound:.4f}",
            tflops=f"{gram_flops(n, p) / ms / 1e9:.2f}", share_of_bound=f"{bound / ms:.3f}",
            device_ms=f"{device_ms:.4f}", host_ms=f"{issue_ms:.4f}",
            device_events_per_call=json.dumps(events), sha256=digest)
        if label == "pipeline":
            out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                       bound_by="operations" if t_ops > t_bytes else "bytes",
                       device_ms=device_ms, host_ms=issue_ms)
        del x
        torch.cuda.empty_cache()
    out["err"] = worst
    return out


def phase_large_scale() -> tuple[dict, dict]:
    """examples/large_scale_glasso.py's pipeline through the port at
    n = 80, p = 16000: covgram on the card -> correlation R (float64) ->
    capacity lambda for p_max -> device screen held to the host screen ->
    Engine(solver="bcd", tol=1e-7).run(R, lam, p_max, labels) with default
    options, which must return a SparseTheta with no (p, p) result buffer;
    the example's blockwise KKT on the five largest components and
    kkt_residual_sparse over all.  Launch counters zeroed just before the
    pipeline and read just after.  Returns (launches, numbers)."""
    from repro_torch.kernels.covgram import covgram

    n, p = LARGE_N, LARGE_P
    X = microarray_like(n, p, seed=LARGE_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instrument.reset("kernels.")
    instrument.reset("result.")
    t_start = time.perf_counter()
    S = covgram(torch.as_tensor(X, dtype=torch.float32).to(DEV))
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    R_dev = (S / torch.outer(d, d)).double()
    R_dev.fill_diagonal_(1.0)
    del S, d
    R = R_dev.cpu().numpy()
    del R_dev
    torch.cuda.empty_cache()
    t_cov = time.perf_counter() - t_start
    t0 = time.perf_counter()
    cap = lambda_for_max_component(R, LARGE_P_MAX)
    t_cap = time.perf_counter() - t0
    lam = cap * 1.0005
    t0 = time.perf_counter()
    labels, _ = thresholded_components(R, lam, backend="pallas", device=DEV)
    t_screen = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, _ = thresholded_components(R, lam)
    t_host = time.perf_counter() - t0
    if not partitions_equal(labels, host):
        raise AssertionError("[large_scale] the device screen's partition differs from host")
    engine = Engine(solver="bcd", tol=LARGE_TOL)
    t0 = time.perf_counter()
    res = engine.run(R, lam, p_max=LARGE_P_MAX, labels=labels)
    t_run = time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    launches = instrument.tail_counts("kernels.")
    result_peak = instrument.counts("result.").get("result.bytes_peak", 0)
    dev_peak = torch.cuda.max_memory_allocated()
    if not isinstance(res.Theta, SparseTheta):
        raise AssertionError(f"[large_scale] default options gave {type(res.Theta).__name__}")
    if not result_peak < p * p * 8 // 16 or res.bytes_peak != result_peak:
        raise AssertionError(f"[large_scale] result bytes {result_peak} vs p^2 8 = {p * p * 8}")
    for name in ("covgram", "threshold_cc"):
        if launches.get(f"{name}.launches", 0) <= 0:
            raise AssertionError(f"{name} was not launched on the [large_scale] path")
    comps = sorted(component_lists(res.labels), key=len, reverse=True)
    top5 = 0.0
    for comp in comps[:5]:
        if len(comp) > 1:
            top5 = max(top5, kkt_residual_host(R[np.ix_(comp, comp)], lam,
                                               res.Theta.gather_block(comp)))
    kkt_all = kkt_residual_sparse(R, res.Theta, lam)
    if not (top5 < LARGE_KKT and kkt_all < LARGE_KKT):
        raise AssertionError(f"[large_scale] KKT top-5 {top5}, all {kkt_all} >= {LARGE_KKT}")
    if max(res.block_sizes or [1]) > LARGE_P_MAX:
        raise AssertionError(f"[large_scale] a block above p_max: {res.block_sizes[:3]}")
    stages = res.stages()
    log("large_scale", n=n, p=p, seed=LARGE_SEED, p_max=LARGE_P_MAX, lam=f"{lam:.6g}",
        n_components=len(comps), max_comp=len(comps[0]),
        route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), output=res.output,
        kkt_top5=top5, kkt_all=kkt_all, result_nbytes=res.bytes_peak,
        dense_nbytes=p * p * 8, max_memory_allocated=dev_peak,
        covariance_s=f"{t_cov:.3f}", capacity_s=f"{t_cap:.3f}",
        device_screen_s=f"{t_screen:.3f}", host_screen_s=f"{t_host:.3f}",
        run_s=f"{t_run:.3f}", plan_s=f"{span_seconds(res, 'engine.plan'):.4f}",
        solve_s=f"{stages['solve']:.4f}", dispatch_s=f"{stages['dispatch']:.4f}",
        assemble_s=f"{stages['assemble']:.4f}", wall_s=f"{wall:.3f}")
    del res
    return launches, dict(R=R, lam=lam, labels=labels, screen_s=t_screen)


def phase_from_data_sparse(X: np.ndarray) -> dict:
    """glasso(X=...) at bench_stream's p = 16000 workload with default
    options: a SparseTheta whose partition equals the dense screen's on the
    card; its sparse KKT and stage split."""
    n, p = X.shape
    lam = FROM_DATA_SPARSE_LAM
    S_dev = sample_covariance(X)
    smax = float(S_dev.abs().max())
    dense_labels, margin = dense_partition(S_dev, lam)
    if margin < MARGIN_RTOL * smax:
        raise AssertionError(f"[from_data_sparse] an |S_ij| lies within {margin} of lam={lam}")
    S = S_dev.cpu().numpy()
    del S_dev
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    instrument.reset("kernels.")
    instrument.reset("result.")
    t0 = time.perf_counter()
    res = glasso(X=X, lam=lam)
    wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    if not isinstance(res.Theta, SparseTheta):
        raise AssertionError(f"[from_data_sparse] default options gave {type(res.Theta).__name__}")
    if not np.array_equal(res.labels, dense_labels):
        raise AssertionError("[from_data_sparse] partition differs from the dense screen's")
    if launches.get("covgram_screen.launches", 0) <= 0:
        raise AssertionError("covgram_screen was not launched on [from_data_sparse]")
    kkt = kkt_residual_sparse(S, res.Theta, lam)
    if not kkt <= KKT_RTOL * smax:
        raise AssertionError(f"[from_data_sparse] KKT {kkt} > {KKT_RTOL}*max|S|")
    stages = res.stages()
    log("from_data_sparse", n=n, p=p, lam=lam, output=res.output,
        route_mix=json.dumps(res.route_mix, sort_keys=True),
        launches=json.dumps(launches, sort_keys=True), kkt=kkt, max_abs_S=smax,
        margin=margin, partition_equals_dense=True, result_nbytes=res.bytes_peak,
        result_bytes_peak=instrument.counts("result.").get("result.bytes_peak", 0),
        wall_s=f"{wall:.3f}", stream_span_s=f"{span_seconds(res, 'engine.screen'):.4f}",
        plan_s=f"{span_seconds(res, 'engine.plan'):.4f}", solve_s=f"{stages['solve']:.4f}",
        dispatch_s=f"{stages['dispatch']:.4f}", assemble_s=f"{stages['assemble']:.4f}")
    return launches


def f32_launches_on_path(kernel: str, calls: list) -> dict:
    """The float32 launches recorded on an [f32] solve against their
    float32 plain versions (the card tests' tolerances), CUDA-event times
    of kernel and plain version summed over them."""
    from repro_torch.kernels.prox_l1 import prox_step, prox_step_ref
    from repro_torch.kernels.shard_prox import fused_prox_ref, fused_prox_residual

    fns = {
        "tree_glasso": (glasso_forest_stack, glasso_forest_ref),
        "bucket_glasso": (fused_bcd_stack, fused_bcd_ref_stack),
        "prox_l1": (prox_step, prox_step_ref),
        "shard_prox": (fused_prox_residual, fused_prox_ref),
    }
    kern, plain = fns[kernel]
    out = dict(n=len(calls), rel_err=0.0, ms=0.0, plain_ms=0.0, shapes=[])
    for i, args, kw in calls:
        if args[0].dtype != torch.float32:
            raise AssertionError(f"[f32] {kernel} launch {i} is {args[0].dtype}")
        got, want = kern(*args, **kw), plain(*args, **kw)
        if kernel == "shard_prox":
            check_shard_prox_f32(got, want, f"[f32] launch {i}")
            rel = 0.0
        else:
            g, w = (got[0], want[0]) if kernel == "bucket_glasso" else (got, want)
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            bound = {"tree_glasso": F32_TREE_RTOL, "bucket_glasso": F32_BUCKET_RTOL,
                     "prox_l1": 0.0}[kernel]
            if not rel <= bound:
                raise AssertionError(f"[f32] {kernel} launch {i}: relative error {rel}")
        out["rel_err"] = max(out["rel_err"], rel)
        out["ms"] += cuda_ms(lambda: kern(*args, **kw), 10)
        out["plain_ms"] += cuda_ms(lambda: plain(*args, **kw), 2)
        out["shapes"].append([i] + list(args[0].shape))
    return out


def phase_f32(S: np.ndarray, lam: float, bcd_res) -> dict:
    """The [main] workload at dtype="float32" with bcd, pg and admm (their
    default tol 1e-7: F32_THETA_RTOL says why): labels and route mix equal
    to the float64 run's, Theta against the float64 bcd solve within
    F32_THETA_RTOL[solver] of max|Theta|; every float32 kernel instance's
    recorded launches held to its float32 plain version.  Launch counters
    zeroed just before each solve and read just after."""
    scale = float(np.abs(bcd_res.Theta).max())
    kernels = {"bcd": (("repro_torch.engine.executor", "glasso_forest_stack", "tree_glasso"),
                       ("repro_torch.core.solvers.bcd", "fused_bcd_stack", "bucket_glasso")),
               "pg": (("repro_torch.core.solvers.pg", "prox_step", "prox_l1"),),
               "admm": (("repro_torch.core.solvers.admm", "fused_prox_residual", "shard_prox"),)}
    timings = {}
    for solver, wrapped in kernels.items():
        opts = EngineOptions(solver=solver, dtype="float32")
        with ExitStack() as stack:
            kept = {kernel: stack.enter_context(record_prox_launches(module, name))
                    for module, name, kernel in wrapped}
            torch.cuda.synchronize()
            instrument.reset("kernels.")
            t0 = time.perf_counter()
            res = glasso(S, lam, options=opts)
            wall = time.perf_counter() - t0
            launches = instrument.tail_counts("kernels.")
        if res.Theta.dtype != np.float32:
            raise AssertionError(f"[f32] {solver}: Theta is {res.Theta.dtype}")
        if not np.array_equal(res.labels, bcd_res.labels) or res.route_mix != bcd_res.route_mix:
            raise AssertionError(f"[f32] {solver}: plan differs from the float64 run's")
        diff = float(np.abs(res.Theta.astype(np.float64) - bcd_res.Theta).max())
        if not diff <= F32_THETA_RTOL[solver] * scale:
            raise AssertionError(f"[f32] {solver}: max|Theta - Theta_f64| = {diff} > "
                                 f"{F32_THETA_RTOL[solver]}*{scale}")
        kkt = float(kkt_residual(torch.as_tensor(S, device=DEV),
                                 torch.as_tensor(res.Theta.astype(np.float64), device=DEV), lam))
        checked = {}
        for _, _, kernel in wrapped:
            if launches.get(f"{kernel}.launches", 0) <= 0:
                raise AssertionError(f"{kernel} was not launched on the [f32] {solver} path")
            if kept[kernel]["n"] != launches[f"{kernel}.launches"]:
                raise AssertionError(f"[f32] {kernel}: {kept[kernel]['n']} recorded, {launches}")
            r = f32_launches_on_path(kernel, first_middle_last(kept[kernel]))
            checked[kernel] = r
            timings[kernel] = r
        stages = res.stages()
        log("f32", solver=solver, dtype="float32", theta_vs_f64=diff, max_abs_theta=scale,
            tol_rel=F32_THETA_RTOL[solver], kkt=kkt,
            launches=json.dumps(launches, sort_keys=True),
            kernels_checked=json.dumps({k: {"launches_checked": v["n"],
                                            "rel_err": v["rel_err"],
                                            "ms": round(v["ms"], 4),
                                            "plain_ms": round(v["plain_ms"], 4),
                                            "shapes": v["shapes"]}
                                        for k, v in checked.items()}),
            wall_s=f"{wall:.3f}", screen_s=f"{stages['screen']:.4f}",
            plan_s=f"{span_seconds(res, 'engine.plan'):.4f}", solve_s=f"{stages['solve']:.4f}",
            dispatch_s=f"{stages['dispatch']:.4f}", assemble_s=f"{stages['assemble']:.4f}")
        del kept
    return timings


def phase_joint_prox_k20() -> None:
    """joint_prox at K = 20 classes (the shared-memory shape) against its
    plain version, float64 and float32, both penalties."""
    from repro_torch.kernels.joint_prox import joint_prox_ref, joint_prox_step

    rng = np.random.default_rng(20)
    n, K, b = JOINT_PROX_K20
    for dtype in (torch.float64, torch.float32):
        for penalty in ("group", "fused"):
            ops = [torch.as_tensor(rng.standard_normal((n, K, b, b)), device=DEV).to(dtype)
                   for _ in range(3)]
            t = torch.as_tensor(np.stack([0.3 * rng.random(n) + 0.01, 0.3 * rng.random(n)],
                                         axis=1), device=DEV).to(dtype)
            got = joint_prox_step(*ops, t, penalty=penalty)
            want = joint_prox_ref(*ops, t, penalty=penalty)
            if dtype == torch.float64:
                err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
                rel = max(float(((g - w).abs() / w.abs()).max()) for g, w in zip(got[2:], want[2:]))
                if not (err <= JOINT_PROX_ATOL and rel <= JOINT_PROX_RTOL):
                    raise AssertionError(f"joint_prox K={K} {penalty}: {err}, {rel}")
            else:
                err = check_joint_prox_f32(got, want, f"K={K} {penalty}")
            ms = cuda_ms(lambda: joint_prox_step(*ops, t, penalty=penalty), 20)
            plain_ms = cuda_ms(lambda: joint_prox_ref(*ops, t, penalty=penalty), 3)
            log("joint_prox", path="k20", K=K, n=n, b=b, penalty=penalty,
                dtype=str(dtype).removeprefix("torch."), max_abs_err=err, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{joint_prox_bound_ms(ops[0]):.6f}")


def flash_bound(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, d: int, causal: bool,
                dtype: torch.dtype) -> tuple[float, float]:
    """(bytes ms, operations ms) of one attention: q, k, v read and o
    written once; 4 B Hq Sq Skv d flops (the two products), halved when
    causal, at the FP32 rate for float32 and the bf16 tensor-core rate for
    bf16."""
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = 2 * B * d * (Hq * Sq + Hkv * Skv) * itemsize / HBM_BYTES_PER_S * 1e3
    flops = 4.0 * B * Hq * Sq * Skv * d / (2 if causal else 1)
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    return t_bytes, flops / peak * 1e3


def sdpa(q, k, v, *, causal: bool, scale: float):
    """The library call for the same function: PyTorch's
    scaled_dot_product_attention, K/V grouped by ``enable_gqa`` (a yardstick;
    the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale,
                                          enable_gqa=q.shape[1] != k.shape[1])


def phase_flash_attention() -> dict:
    """The flash_attention kernel against its plain version on FLASH_CASES;
    CUDA-event and profiler device times beside the bound, the plain
    version and SDPA.  Returns the serving shape's float32 numbers (the
    [serve] path's launches) and, under "bf16", its bf16 numbers (the
    [prefill_bf16] path's, the wgmma body)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.models.attention import _sdpa_chunked

    rng = np.random.default_rng(17)
    out = {}
    for label, B, Hq, Hkv, Sq, Skv, d, causal, dtype in FLASH_CASES:
        q, k, v = (torch.as_tensor(rng.standard_normal(sh, dtype=np.float32), device=DEV)
                   .to(dtype) for sh in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d)))
        scale = d ** -0.5
        if label == "long":
            def plain():
                return _sdpa_chunked(q, k, v, scale=scale, causal=causal)
        else:
            def plain():
                return attention_ref(q, k, v, causal=causal, scale=scale)
        instrument.reset("kernels.")
        got, want = flash_attention(q, k, v, causal=causal), plain()
        if got.dtype != dtype or got.shape != q.shape:
            raise AssertionError(f"flash_attention {label}: {got.dtype} {tuple(got.shape)}")
        if instrument.count("kernels.flash_attention.launches") != 1:
            raise AssertionError(f"flash_attention {label}: not one launch")
        body = "wgmma" if instrument.count("kernels.flash_attention.wgmma_launches") else "fp32"
        if body != ("wgmma" if dtype == torch.bfloat16 else "fp32"):
            raise AssertionError(f"flash_attention {label} {dtype} ran the {body} body")
        err = float((got.float() - want.float()).abs().max())
        if not err <= FLASH_ATOL[dtype]:
            raise AssertionError(f"flash_attention {label} {dtype}: max|diff| {err} > "
                                 f"{FLASH_ATOL[dtype]}")
        lib_err = float((sdpa(q, k, v, causal=causal, scale=scale).float()
                         - want.float()).abs().max())
        del got, want
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), 10)
        device_ms = kernel_device_ms(lambda: flash_attention(q, k, v, causal=causal),
                                     "flash_attention", 3 if label == "long" else 10)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(lambda: sdpa(q, k, v, causal=causal, scale=scale), 10)
        t_bytes, t_ops = flash_bound(B, Hq, Hkv, Sq, Skv, d, causal, dtype)
        bound = max(t_bytes, t_ops)
        log("flash_attention", case=label, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, d=d,
            causal=causal, dtype=str(dtype).removeprefix("torch."), body=body,
            max_abs_err=err, tol=FLASH_ATOL[dtype],
            plain="chunked" if label == "long" else "attention_ref", ms=f"{ms:.4f}",
            device_ms=f"{device_ms:.4f}" if device_ms else "not_measured",
            plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{library_ms:.4f}",
            sdpa_max_abs_err=lib_err, bytes_ms=f"{t_bytes:.4f}", ops_ms=f"{t_ops:.4f}",
            bound_ms=f"{bound:.4f}", share_of_bound=f"{bound / ms:.3f}",
            sdpa_over_kernel=f"{library_ms / ms:.3f}")
        row = dict(err=err, ms=ms, device_ms=device_ms or None, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound,
                   bound_by="operations" if t_ops > t_bytes else "bytes")
        if label == "full_width":
            if dtype == torch.float32:
                out.update(row)
            else:
                out["bf16"] = row
        elif label == "moe_gqa":
            out["moe_gqa"] = row
        elif d > 128:
            out.setdefault("wide", {})[f"{str(dtype).removeprefix('torch.')}_d{d}"] = row
        del q, k, v
        torch.cuda.empty_cache()
    return out


def max_abs(x: torch.Tensor) -> float:
    return float(x.abs().max())


def phase_serve() -> dict:
    """The LM serving path at full width through launch/serve.py's
    run_serving: the parameter count, flash launches per prefill (one a
    layer), init / prefill / decode times and peak memory; then the
    kernel's prefill logits against the dense path's on the card, and two
    decode steps against fresh prefills of the extended prompt; the
    kernel's device ms a prefill (profiler); one decode step under the
    profiler.  Returns the serving run's launches."""
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.transformer import padded_vocab

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    instrument.reset("kernels.")
    run = run_serving(arch=SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      new_tokens=SERVE_NEW, reduced=False, seed=0, device="cuda",
                      log=lambda msg: None)
    launches = instrument.tail_counts("kernels.")
    peak = torch.cuda.max_memory_allocated() - base
    model, batch, cfg = run.model, run.batch, run.model.cfg
    n_flash = launches.get("flash_attention.launches", 0)
    if run.n_params != SERVE_PARAMS:
        raise AssertionError(f"[serve] {run.n_params:,} parameters, expected {SERVE_PARAMS:,}")
    if n_flash != cfg.n_layers:
        raise AssertionError(f"[serve] {n_flash} flash launches for {cfg.n_layers} layers")
    toks = run.tokens
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= padded_vocab(cfg):
        raise AssertionError(f"[serve] tokens {tuple(toks.shape)} out of range")
    with torch.inference_mode():
        instrument.reset("kernels.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(batch, capacity=SERVE_PROMPT + 2)
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - t0
        if instrument.count("kernels.flash_attention.launches") != cfg.n_layers:
            raise AssertionError("[serve] the check's prefill did not launch flash_attention")
        flash_ms = kernel_device_ms(lambda: model.prefill(batch, capacity=SERVE_PROMPT + 2),
                                    "flash_attention", 2, per_call=cfg.n_layers)
        t0 = time.perf_counter()
        dense, _ = model.prefill(batch, use_flash=False)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        if not (torch.isfinite(logits).all() and torch.isfinite(dense).all()):
            raise AssertionError("[serve] non-finite prefill logits")
        scale = max_abs(dense)
        err = max_abs(logits - dense)
        if not err <= SERVE_LOGITS_RTOL * scale:
            raise AssertionError(f"[serve] flash prefill vs dense: {err} > "
                                 f"{SERVE_LOGITS_RTOL} * {scale}")
        argmax_equal = bool(torch.equal(logits.argmax(-1), dense.argmax(-1)))
        del dense
        tokens = batch["tokens"]
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        step_errs = []
        for step in range(2):
            dec, caches = model.decode_step(tok, caches, SERVE_PROMPT + step)
            tokens = torch.cat([tokens, tok], dim=1)
            fresh, _ = model.prefill({"tokens": tokens})
            e, bound = max_abs(dec - fresh), SERVE_LOGITS_RTOL * max_abs(fresh)
            if not e <= bound:
                raise AssertionError(f"[serve] decode step {step} vs fresh prefill: {e} > {bound}")
            step_errs.append(e)
            tok = torch.argmax(dec, dim=-1)[:, None].to(torch.int32)
            del fresh
        device_busy("serve", f"{cfg.name} decode step B={SERVE_BATCH} pos={SERVE_PROMPT + 1}",
                    lambda: model.decode_step(tok, caches, SERVE_PROMPT + 1))
    log("serve", arch=cfg.name, dtype=cfg.dtype, params=run.n_params, batch=SERVE_BATCH,
        prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        flash_launches_per_prefill=n_flash, launches=json.dumps(launches, sort_keys=True),
        init_s=f"{run.init_s:.3f}", prefill_s=f"{run.prefill_s:.3f}",
        decode_s=f"{run.decode_s:.3f}",
        decode_ms_per_step=f"{run.decode_s / run.decode_steps * 1e3:.3f}",
        decode_tokens_per_s=f"{SERVE_BATCH * run.decode_steps / run.decode_s:.1f}",
        tokens_per_s=f"{run.tokens_per_s:.1f}", peak_bytes=peak,
        check_prefill_flash_s=f"{flash_s:.3f}", check_prefill_dense_s=f"{dense_s:.3f}",
        flash_device_ms=f"{flash_ms:.3f}",
        flash_share_of_prefill=f"{flash_ms / (flash_s * 1e3):.4f}",
        logits_vs_dense=err, max_abs_logits=scale, logits_tol_rel=SERVE_LOGITS_RTOL,
        argmax_equal=argmax_equal, decode_vs_fresh_prefill=json.dumps(step_errs),
        tokens_row0=json.dumps(toks[0].tolist()))
    del run, model, batch, caches, logits, tokens
    torch.cuda.empty_cache()
    return launches


def phase_prefill_bf16() -> dict:
    """qwen2.5-3b at full width in its config's own bfloat16: one prefill of
    SERVE_BATCH prompts of SERVE_PROMPT tokens through Model.prefill, whose
    36 self-attentions run flash_attention's wgmma body (counters zeroed
    just before the timed prefill, read just after); the kernel's device
    share of the prefill from the profiler; the dense path's prefill time;
    the logits against the dense path's within PREFILL_BF16_RTOL of
    max|logits| and their argmax agreement; peak bytes of each."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.specs import make_batch
    from repro_torch.models.zoo import build_model, count_params

    cfg = get_arch(SERVE_ARCH)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"[prefill_bf16] {cfg.name}'s config dtype is {cfg.dtype}")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda")
    model.init(0)
    n_params = count_params(model)
    if n_params != SERVE_PARAMS:
        raise AssertionError(
            f"[prefill_bf16] {n_params:,} parameters, expected {SERVE_PARAMS:,}")
    batch = make_batch(cfg, ShapeConfig("prefill_bf16", SERVE_PROMPT, SERVE_BATCH, "prefill"),
                       seed=0, device="cuda")
    with torch.inference_mode():
        model.prefill(batch)  # warm-up: cuBLAS's bf16 kernels and workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        instrument.reset("kernels.")
        t0 = time.perf_counter()
        logits, caches = model.prefill(batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = instrument.tail_counts("kernels.")
        peak = torch.cuda.max_memory_allocated() - base
        del caches
        n_wgmma = launches.get("flash_attention.wgmma_launches", 0)
        if n_wgmma != cfg.n_layers or launches.get("flash_attention.launches") != cfg.n_layers:
            raise AssertionError(f"[prefill_bf16] {launches} for {cfg.n_layers} layers")
        flash_ms = kernel_device_ms(lambda: model.prefill(batch), "flash_attention", 2,
                                    per_call=cfg.n_layers)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense, _ = model.prefill(batch, use_flash=False)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        dense_peak = torch.cuda.max_memory_allocated() - base
        if logits.dtype != torch.bfloat16 or logits.shape != dense.shape:
            raise AssertionError(f"[prefill_bf16] logits {logits.dtype} {tuple(logits.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(dense).all()):
            raise AssertionError("[prefill_bf16] non-finite prefill logits")
        scale = max_abs(dense.float())
        err = max_abs(logits.float() - dense.float())
        if not err <= PREFILL_BF16_RTOL * scale:
            raise AssertionError(f"[prefill_bf16] flash prefill vs dense: {err} > "
                                 f"{PREFILL_BF16_RTOL} * {scale}")
        argmax_rows = int((logits.argmax(-1) == dense.argmax(-1)).sum())
    log("prefill_bf16", arch=cfg.name, dtype=cfg.dtype, params=n_params, batch=SERVE_BATCH,
        prompt_len=SERVE_PROMPT, launches=json.dumps(launches, sort_keys=True),
        wgmma_launches_per_prefill=n_wgmma, prefill_s=f"{prefill_s:.4f}",
        flash_device_ms=f"{flash_ms:.3f}",
        flash_share_of_prefill=f"{flash_ms / (prefill_s * 1e3):.4f}",
        dense_prefill_s=f"{dense_s:.4f}", peak_bytes=peak, dense_peak_bytes=dense_peak,
        logits_vs_dense=err, max_abs_logits=scale, logits_tol_rel=PREFILL_BF16_RTOL,
        argmax_equal_rows=f"{argmax_rows}/{SERVE_BATCH}")
    del model, batch, logits, dense
    torch.cuda.empty_cache()
    return launches


@contextmanager
def timed_train_steps():
    """Wall seconds of every train step made inside the block, the device
    synchronised at the end of each (``make_train_step`` wrapped where
    ``run_training`` looks it up)."""
    import repro_torch.train.step as step_mod

    inner = step_mod.make_train_step
    seconds: list[float] = []

    def timed(*args, **kwargs):
        fn = inner(*args, **kwargs)

        def step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        return step

    step_mod.make_train_step = timed
    try:
        yield seconds
    finally:
        step_mod.make_train_step = inner


def recording_optimizer(opt, box: dict):
    """``opt`` with its update's gradients copied into ``box`` first (the
    update consumes them in place)."""
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.train.tree import tree_map

    def update(grads, state, params, step):
        box["grads"] = tree_map(torch.clone, grads)
        return opt.update(grads, state, params, step)

    return Optimizer(init=opt.init, update=update)


def train_oracle() -> dict:
    """A TRAIN_ORACLE_LAYERS-layer cut of qwen2.5-3b's widths (full vocab)
    takes one make_train_step step in float32 and in float64 from the same
    float32 master parameters and batch; the float32 gradients against the
    float64 ones, relative to the float64 global norm."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves

    cut = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=TRAIN_ORACLE_LAYERS,
                              dtype="float32")
    batch = SyntheticLM(cut, ShapeConfig("oracle", TRAIN_SEQ, TRAIN_BATCH, "train"),
                        seed=1, device="cuda").batch_at(0)
    grads, losses = {}, {}
    for dtype in ("float32", "float64"):
        box: dict = {}
        opt = recording_optimizer(adamw(3e-4), box)
        # the same float32 master parameters for both (drawn at the cut's
        # float32); the float64 model casts them up and computes in float64
        state, _ = init_state(build_model(cut, device="meta"), opt, 0, device="cuda")
        model = build_model(dataclasses.replace(cut, dtype=dtype), device="meta")
        state, metrics = make_train_step(model, opt, remat="none")(state, batch)
        losses[dtype] = float(metrics["loss"])
        grads[dtype] = leaves(box["grads"])
        del state, box
    diff_sq = sum(float((a.double() - b.double()).square().sum())
                  for a, b in zip(grads["float32"], grads["float64"]))
    norm64 = math.sqrt(sum(float(b.double().square().sum()) for b in grads["float64"]))
    worst = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(grads["float32"], grads["float64"]))
    rel = math.sqrt(diff_sq) / norm64
    if not (math.isfinite(rel) and rel <= TRAIN_ORACLE_RTOL):
        raise AssertionError(f"[train_oracle] float32 gradients vs float64: {rel} of the "
                             f"global norm > {TRAIN_ORACLE_RTOL}")
    out = dict(layers=TRAIN_ORACLE_LAYERS, loss_f32=losses["float32"],
               loss_f64=losses["float64"], grad_norm_f64=norm64, grad_rel_err=rel,
               grad_max_abs_err=worst, tol_rel=TRAIN_ORACLE_RTOL)
    del grads
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(arch: str = SERVE_ARCH, steps: int = 12) -> dict:
    """``arch``'s reduced config takes ``steps`` steps of make_train_step
    (AdamW on the 12-step cosine schedule, SyntheticLM batches of 4 x 32,
    remat "none") on the card and on the CPU from the same initial
    state."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves, tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg, device="meta")
    opt = adamw(cosine_with_warmup(3e-4, warmup=10, total=12))
    start, _ = init_state(model, opt, 0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        state = tree_map(lambda t: t.to(dev, copy=True), start)
        data = SyntheticLM(cfg, ShapeConfig("card_cpu", 32, 4, "train"), seed=0, device=dev)
        step = make_train_step(model, opt, remat="none")
        losses = []
        for i in range(steps):
            state, metrics = step(state, data.batch_at(i))
            losses.append(float(metrics["loss"]))
        runs[dev] = (losses, [t.cpu() for t in leaves(state)],
                     [t.cpu() for t in leaves(state.params)])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    param_err = max(float((a - b).abs().max()) for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
    # the parameters' difference against how far the 12 steps moved them
    moved = math.sqrt(sum(float((b - a).double().square().sum())
                          for a, b in zip(leaves(start.params), runs["cpu"][2])))
    diff = math.sqrt(sum(float((a - b).double().square().sum())
                         for a, b in zip(runs["cuda"][2], runs["cpu"][2])))
    if not (loss_err <= TRAIN_CARD_CPU_RTOL and param_err <= TRAIN_CARD_CPU_ATOL):
        raise AssertionError(f"[train_card_cpu] {cfg.name}, {steps} steps: losses {loss_err} "
                             f"(rel), state {param_err} (abs) against {TRAIN_CARD_CPU_RTOL} / "
                             f"{TRAIN_CARD_CPU_ATOL}")
    return dict(arch=cfg.name, steps=steps, loss_rel_err=loss_err, state_max_abs_err=param_err,
                params_diff_over_moved=diff / moved, tol_rel=TRAIN_CARD_CPU_RTOL,
                tol_abs=TRAIN_CARD_CPU_ATOL)


def train_restart() -> dict:
    """The reduced config's bit-exact restart on the card: 12 steps straight
    against 6, a checkpoint, a resume and 6 more, under
    torch.use_deterministic_algorithms (which raises at an operation whose
    result depends on the order of atomic adds), in a temporary
    directory."""
    import tempfile

    from repro_torch.launch.train import run_training
    from repro_torch.train.tree import leaves

    common = dict(arch=SERVE_ARCH, batch=4, seq=32, reduced=True, ckpt_every=6,
                  log=lambda *a, **k: None, device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            state_a, losses_a, _ = run_training(steps=12, ckpt_dir=None, **common)
            _, losses_b1, _ = run_training(steps=6, ckpt_dir=tmp, **common)
            state_b, losses_b2, _ = run_training(steps=12, ckpt_dir=tmp, resume=True, **common)
    finally:
        torch.use_deterministic_algorithms(False)
    equal = int(state_a.step) == int(state_b.step) == 12 and all(
        torch.equal(a, b) for a, b in zip(leaves(state_a), leaves(state_b)))
    if not (equal and losses_a == losses_b1 + losses_b2):
        raise AssertionError("[train_restart] 6 + resume + 6 steps differ from 12 straight")
    return dict(steps=12, resumed_at=6, leaves=len(leaves(state_a)), bit_equal=True)


def phase_train() -> dict:
    """LM training at full width: run_training on qwen2.5-3b's full config
    (36 layers, float32, AdamW, remat "none"), TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens on the card.  The kernel counters are
    zeroed just before and read just after: training launches no ported
    kernel (attention trains through the plain _sdpa under autograd).
    Every loss must be finite and the last below the first.  Then the
    float64 oracle of a 2-layer cut, the reduced config on the card
    against the CPU, and the bit-exact restart on the card."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import run_training
    from repro_torch.train.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lines: list[str] = []
    instrument.reset("kernels.")
    t0 = time.perf_counter()
    with timed_train_steps() as step_s:
        state, losses, status = run_training(
            arch=SERVE_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            reduced=False, device="cuda", log=lines.append)
    wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(t.numel() for t in leaves(state.params))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if status != "done" or len(losses) != TRAIN_STEPS or n_params != SERVE_PARAMS:
        raise AssertionError(f"[train] status {status}, {len(losses)} losses, "
                             f"{n_params:,} parameters")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] losses {losses}: not finite or not falling")
    if any(launches.values()):
        raise AssertionError(f"[train] training launched ported kernels: {launches}")
    steady = step_s[1:]
    step_mean = sum(steady) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    log("train", arch=SERVE_ARCH, layers=get_arch(SERVE_ARCH).n_layers, dtype="float32", optimizer="adamw", remat="none",
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        losses=json.dumps(losses), step_s=json.dumps([round(x, 4) for x in step_s]),
        first_step_s=f"{step_s[0]:.4f}", step_s_after_first=f"{step_mean:.4f}",
        tokens_per_s=f"{tokens / step_mean:.1f}", peak_bytes=peak, base_bytes=base,
        model_flops_per_step=flops,
        mfu_fp32=f"{flops / step_mean / FP32_PEAK_FLOPS:.4f}",
        run_training_s=f"{wall:.2f}", kernel_launches=json.dumps(launches),
        first_log_line=json.dumps(lines[0] if lines else ""))
    t0 = time.perf_counter()
    oracle = train_oracle()
    log("train_oracle", seconds=f"{time.perf_counter() - t0:.2f}", **oracle)
    t0 = time.perf_counter()
    card_cpu = train_card_vs_cpu()
    log("train_card_cpu", seconds=f"{time.perf_counter() - t0:.2f}", **card_cpu)
    t0 = time.perf_counter()
    restart = train_restart()
    log("train_restart", seconds=f"{time.perf_counter() - t0:.2f}", **restart)
    return dict(losses=losses, step_s=step_mean, peak=peak)


@contextmanager
def recorded_routing():
    """The expert choices of every MoE layer call made inside the block, in
    call order: each a (rows, top_k) tensor sorted within its rows, so a
    row is its token's top-k set (``models.moe.route`` wrapped where
    ``moe_apply`` looks it up)."""
    import repro_torch.models.moe as moe_mod

    inner = moe_mod.route
    calls: list[torch.Tensor] = []

    def route(p, xt, *, top_k):
        out = inner(p, xt, top_k=top_k)
        calls.append(torch.sort(out[2], dim=-1).values)
        return out

    moe_mod.route = route
    try:
        yield calls
    finally:
        moe_mod.route = inner


def routing_flips(a: list, b: list, rows_b=None) -> int:
    """The (layer, token) top-k sets that differ between two runs' recorded
    choices; ``rows_b`` picks, in each of b's layer calls, the rows of a's
    tokens (all rows by default)."""
    if len(a) != len(b):
        raise AssertionError(f"routing recorded {len(a)} against {len(b)} layer calls")
    flips = 0
    for x, y in zip(a, b):
        y = y if rows_b is None else y[rows_b]
        flips += int((x != y).any(dim=-1).sum())
    return flips


def phase_serve_moe(phase: str, cfg, n_params: int) -> dict:
    """The MoE family at full width through run_serving (dropless routing):
    the parameter count, flash launches a prefill (one a layer with GQA,
    none with MLA), init / prefill / decode times and peak memory; then,
    with GQA, the kernel's prefill logits against the dense path's; two
    decode steps against fresh prefills of the extended prompt; each check
    beside the count of (layer, token) top-k sets that differ between the
    two runs it compares, so a failure through a routing flip reads as
    one."""
    import gc

    from repro_torch.launch.serve import run_serving
    from repro_torch.models.transformer import padded_vocab

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flash_want = 0 if cfg.mla else cfg.n_layers
    instrument.reset("kernels.")
    run = run_serving(arch=cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      new_tokens=SERVE_NEW, reduced=False, seed=0, device="cuda",
                      log=lambda msg: None)
    launches = instrument.tail_counts("kernels.")
    peak = torch.cuda.max_memory_allocated() - base
    model, batch, cfg = run.model, run.batch, run.model.cfg
    n_flash = launches.get("flash_attention.launches", 0)
    if run.n_params != n_params:
        raise AssertionError(f"[{phase}] {run.n_params:,} parameters, expected {n_params:,}")
    if n_flash != flash_want:
        raise AssertionError(f"[{phase}] {n_flash} flash launches, expected {flash_want}")
    toks = run.tokens
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= padded_vocab(cfg):
        raise AssertionError(f"[{phase}] tokens {tuple(toks.shape)} out of range")
    fields: dict = {}
    failures: list[str] = []
    with torch.inference_mode():
        instrument.reset("kernels.")
        with recorded_routing() as routed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.prefill(batch, capacity=SERVE_PROMPT + 2)
            torch.cuda.synchronize()
            fields["check_prefill_s"] = f"{time.perf_counter() - t0:.3f}"
        if instrument.count("kernels.flash_attention.launches") != flash_want:
            raise AssertionError(f"[{phase}] the check's prefill: flash launches "
                                 f"{instrument.count('kernels.flash_attention.launches')}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"[{phase}] non-finite prefill logits")
        if flash_want:
            flash_ms = kernel_device_ms(
                lambda: model.prefill(batch, capacity=SERVE_PROMPT + 2), "flash_attention", 2,
                per_call=cfg.n_layers)
            with recorded_routing() as routed_dense:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dense, _ = model.prefill(batch, use_flash=False)
                torch.cuda.synchronize()
            scale, err = max_abs(dense), max_abs(logits - dense)
            flips = routing_flips(routed, routed_dense)
            fields.update(check_prefill_dense_s=f"{time.perf_counter() - t0:.3f}",
                          flash_device_ms=f"{flash_ms:.3f}",
                          flash_share_of_prefill=f"{flash_ms / (run.prefill_s * 1e3):.4f}",
                          logits_vs_dense=err, max_abs_logits=scale,
                          routing_flips_flash_vs_dense=flips,
                          argmax_equal=bool(torch.equal(logits.argmax(-1), dense.argmax(-1))))
            if not err <= SERVE_LOGITS_RTOL * scale:
                failures.append(f"flash prefill vs dense: {err} > {SERVE_LOGITS_RTOL} * "
                                f"{scale} ({flips} (layer, token) top-k sets differ)")
            del dense
        tokens = batch["tokens"]
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        step_errs, step_flips = [], []
        for step in range(2):
            with recorded_routing() as routed_dec:
                dec, caches = model.decode_step(tok, caches, SERVE_PROMPT + step)
            tokens = torch.cat([tokens, tok], dim=1)
            with recorded_routing() as routed_fresh:
                fresh, _ = model.prefill({"tokens": tokens})
            S1 = tokens.shape[1]
            last = torch.arange(SERVE_BATCH, device=tokens.device) * S1 + S1 - 1
            flips = routing_flips(routed_dec, routed_fresh, rows_b=last)
            e, bound = max_abs(dec - fresh), SERVE_LOGITS_RTOL * max_abs(fresh)
            step_errs.append(e)
            step_flips.append(flips)
            if not e <= bound:
                failures.append(f"decode step {step} vs fresh prefill: {e} > {bound} "
                                f"({flips} (layer, token) top-k sets differ)")
            tok = torch.argmax(dec, dim=-1)[:, None].to(torch.int32)
            del fresh
    log(phase, arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, params=run.n_params,
        batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        flash_launches_per_prefill=n_flash, launches=json.dumps(launches, sort_keys=True),
        init_s=f"{run.init_s:.3f}", prefill_s=f"{run.prefill_s:.3f}",
        decode_s=f"{run.decode_s:.3f}",
        decode_ms_per_step=f"{run.decode_s / run.decode_steps * 1e3:.3f}",
        decode_tokens_per_s=f"{SERVE_BATCH * run.decode_steps / run.decode_s:.1f}",
        tokens_per_s=f"{run.tokens_per_s:.1f}", peak_bytes=peak, **fields,
        logits_tol_rel=SERVE_LOGITS_RTOL, decode_vs_fresh_prefill=json.dumps(step_errs),
        routing_flips_decode_vs_fresh=json.dumps(step_flips),
        tokens_row0=json.dumps(toks[0].tolist()))
    if failures:
        raise AssertionError(f"[{phase}] " + "; ".join(failures))
    out = dict(launches=launches, flash_device_ms=fields.get("flash_device_ms"))
    del run, model, batch, caches, logits, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phases_moe() -> dict:
    """The MoE family's phases: [serve_moe] (deepseek-v2-lite-16b at full
    width and depth), [serve_moe_gqa] (qwen3-moe-30b-a3b at full width, its
    depth cut to SERVE_MOE_GQA_LAYERS) and [train_moe].  Returns
    [serve_moe_gqa]'s results (its flash launches and device ms)."""
    from repro_torch.configs import get_arch

    phase_serve_moe("serve_moe", get_arch(SERVE_MOE_ARCH), SERVE_MOE_PARAMS)
    moe_gqa = phase_serve_moe(
        "serve_moe_gqa",
        dataclasses.replace(get_arch(SERVE_MOE_GQA_ARCH), n_layers=SERVE_MOE_GQA_LAYERS),
        SERVE_MOE_GQA_PARAMS)
    phase_train_moe()
    return moe_gqa


def phase_train_moe() -> dict:
    """MoE training at full width: a TRAIN_MOE_LAYERS-layer cut of
    deepseek-v2-lite (MLA, shared and routed experts, full vocab) takes
    TRAIN_MOE_STEPS make_train_step steps in float32 from seed 0, routing at
    capacity.  Every loss and aux must be finite and some pairs must drop;
    no ported kernel runs.  Then the reduced config's one step on the card
    against the CPU."""
    import gc
    import types

    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.models.zoo import active_params, build_model
    from repro_torch.optim import adamw
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(get_arch(SERVE_MOE_ARCH), n_layers=TRAIN_MOE_LAYERS,
                              dtype="float32")
    model = build_model(cut, device="meta")
    opt = adamw(3e-4)
    state, _ = init_state(model, opt, 0, device="cuda")
    n_params = sum(t.numel() for t in leaves(state.params))
    if n_params != TRAIN_MOE_PARAMS:
        raise AssertionError(f"[train_moe] {n_params:,} parameters, expected "
                             f"{TRAIN_MOE_PARAMS:,}")
    auxs: list[float] = []

    def train_loss(params, batch, remat_policy=None):
        loss, metrics = model.train_loss(params, batch, remat_policy=remat_policy)
        auxs.append(float(metrics["aux"].detach()))
        return loss, metrics

    step = make_train_step(types.SimpleNamespace(cfg=cut, train_loss=train_loss), opt,
                           remat="none")
    data = SyntheticLM(cut, ShapeConfig("train_moe", TRAIN_MOE_SEQ, TRAIN_MOE_BATCH, "train"),
                       seed=0, device="cuda")
    kept = [0, 0]
    inner = moe_mod.kept_pairs

    def counting(idx, **kw):
        out = inner(idx, **kw)
        kept[0] += out[0].numel()
        kept[1] += idx.numel()
        return out

    losses, step_s = [], []
    instrument.reset("kernels.")
    moe_mod.kept_pairs = counting
    try:
        for i in range(TRAIN_MOE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, data.batch_at(i))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    finally:
        moe_mod.kept_pairs = inner
    launches = instrument.tail_counts("kernels.")
    peak = torch.cuda.max_memory_allocated() - base
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + auxs) or not all(a > 0 for a in auxs):
        raise AssertionError(f"[train_moe] losses {losses}, aux {auxs}")
    if not 0 < kept[0] < kept[1]:
        raise AssertionError(f"[train_moe] {kept[0]} of {kept[1]} pairs kept: not at capacity")
    if any(launches.values()):
        raise AssertionError(f"[train_moe] training launched ported kernels: {launches}")
    tokens = TRAIN_MOE_BATCH * TRAIN_MOE_SEQ
    steady = step_s[1:]
    step_mean = sum(steady) / len(steady)
    active = active_params(cut)
    flops = 6 * active * tokens
    log("train_moe", arch=cut.name, layers=cut.n_layers, dtype=cut.dtype, optimizer="adamw",
        remat="none", params=n_params, active_params=active, batch=TRAIN_MOE_BATCH,
        seq=TRAIN_MOE_SEQ, steps=TRAIN_MOE_STEPS, losses=json.dumps(losses),
        aux=json.dumps(auxs), pairs_kept=kept[0], pairs=kept[1],
        step_s=json.dumps([round(x, 4) for x in step_s]),
        step_s_after_first=f"{step_mean:.4f}", tokens_per_s=f"{tokens / step_mean:.1f}",
        peak_bytes=peak, model_flops_per_step=flops,
        mfu_fp32=f"{flops / step_mean / FP32_PEAK_FLOPS:.4f}",
        kernel_launches=json.dumps(launches))
    t0 = time.perf_counter()
    card_cpu = train_card_vs_cpu(SERVE_MOE_ARCH, steps=1)
    log("train_moe_card_cpu", seconds=f"{time.perf_counter() - t0:.2f}", **card_cpu)
    return dict(losses=losses, aux=auxs, step_s=step_mean, peak=peak)


# ---------------------------------------------------------- phases 26-30


@contextmanager
def launches_per_solve():
    """The ``kernels.*`` counts each ``BucketExecutor.solve_plan`` call adds
    inside the block, one dict a call: a path's steps, or a loop of single
    solves, one entry each."""
    cls = importlib.import_module("repro_torch.engine.executor").BucketExecutor
    inner = cls.solve_plan
    steps: list[dict] = []

    def counting(self, *args, **kwargs):
        before = instrument.tail_counts("kernels.")
        out = inner(self, *args, **kwargs)
        after = instrument.tail_counts("kernels.")
        steps.append({k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)})
        return out

    cls.solve_plan = counting
    try:
        yield steps
    finally:
        cls.solve_plan = inner


def per_step(steps: list[dict], kernel: str) -> list[int]:
    return [s.get(f"{kernel}.launches", 0) for s in steps]


def block_diff(a, b) -> float:
    """max |Theta_a - Theta_b| over the blocks of two sparse results of one
    partition, matched by component (the path's lifetime bucketing orders
    components differently from a single solve's plan)."""
    return sparse_diff(a.Theta, b.Theta)


def phase_path() -> dict:
    """``glasso_path`` on bench_select's workload at its own size: the warm
    path (recorded for [path_kernels], then timed), the cold-restart loop
    (one ``glasso`` a lambda) and ``warm_start=False``; labels, KKT,
    warm == cold and the warm fraction checked at every step."""
    K, p1 = PATH_CASE
    S = structured_synthetic(K, p1, tree_frac=0.2, chordal_frac=0.2, seed=1)
    lams = [float(v) for v in np.linspace(*PATH_GRID)]
    opts = EngineOptions(output="sparse", solver_opts={"tol": PATH_TOL})
    smax = float(np.abs(S).max())
    case = f"bench_select K={K} p1={p1} p={S.shape[0]} lams={len(lams)}"
    torch.cuda.synchronize()
    for prefix in ("kernels.", "select.warm.", "planner.", "router.fallback.", "partition."):
        instrument.reset(prefix)
    with record_results("repro_torch.core.solvers.bcd", "fused_bcd_stack") as bcd_calls, \
            record_results("repro_torch.engine.executor", "glasso_forest_stack") as tree_calls, \
            launches_per_solve() as path_steps:
        t0 = time.perf_counter()
        warm = glasso_path(S, lams, options=opts)
        wall_first = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    warm_counts = instrument.tail_counts("select.warm.")
    planner = instrument.tail_counts("planner.")
    fallbacks = instrument.tail_counts("router.fallback.")
    passes = instrument.count("partition.unionfind_passes")
    for name in ("tree_glasso", "bucket_glasso"):
        if launches.get(f"{name}.launches", 0) <= 0:
            raise AssertionError(f"[path] {name} was not launched on the path")
    if passes != 1:
        raise AssertionError(f"[path] {passes} union-find passes for one path")
    total = sum(warm_counts.values())
    warm_fraction = (warm_counts.get("reused", 0) + warm_counts.get("merged", 0)) / max(total, 1)
    if not warm_fraction >= PATH_WARM_FRACTION:
        raise AssertionError(f"[path] warm fraction {warm_fraction} < {PATH_WARM_FRACTION}")
    kkts = []
    for r in warm:
        if not np.array_equal(r.labels, components_from_covariance_host(S, r.lam)):
            raise AssertionError(f"[path] lam={r.lam}: labels differ from the host screen")
        kkt = kkt_residual_sparse(S, r.Theta, r.lam)
        if not kkt <= KKT_RTOL * smax:
            raise AssertionError(f"[path] lam={r.lam}: KKT {kkt} > {KKT_RTOL}*max|S|")
        kkts.append(kkt)
    # timed arms: the warm path again, the cold-restart loop, the shared plan cold
    t0 = time.perf_counter()
    glasso_path(S, lams, options=opts)
    wall_warm = time.perf_counter() - t0
    with launches_per_solve() as cold_steps:
        t0 = time.perf_counter()
        cold = [glasso(S, lam, options=opts) for lam in lams]
        wall_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    shared = glasso_path(S, lams, warm_start=False, options=opts)
    wall_shared = time.perf_counter() - t0
    diffs = [block_diff(w, c) for w, c in zip(warm, cold)]
    diff_shared = max(block_diff(w, c) for w, c in zip(warm, shared))
    if not max(diffs) < PATH_WARM_GATE:
        raise AssertionError(f"[path] warm vs cold-restart max|dTheta| {max(diffs)} >= {PATH_WARM_GATE}")
    log("path", case=case, lams=f"{lams[0]:.4f}..{lams[-1]:.4f}", tol=PATH_TOL,
        wall_warm_s=f"{wall_warm:.3f}", wall_cold_s=f"{wall_cold:.3f}",
        wall_shared_plan_cold_s=f"{wall_shared:.3f}", wall_first_recorded_s=f"{wall_first:.3f}",
        warm_speedup=f"{wall_cold / wall_warm:.3f}", warm_fraction=f"{warm_fraction:.4f}",
        warm_counts=json.dumps(warm_counts, sort_keys=True),
        planner=json.dumps(planner, sort_keys=True), unionfind_passes=passes,
        fallbacks=json.dumps(fallbacks, sort_keys=True),
        max_dtheta_vs_cold=max(diffs), max_dtheta_vs_shared_plan_cold=diff_shared,
        kkt_max=max(kkts), max_abs_S=smax,
        launches=json.dumps(launches, sort_keys=True))
    log("path_launches", arm="warm path",
        bucket_glasso=json.dumps(per_step(path_steps, "bucket_glasso")),
        tree_glasso=json.dumps(per_step(path_steps, "tree_glasso")))
    log("path_launches", arm="cold loop",
        bucket_glasso=json.dumps(per_step(cold_steps, "bucket_glasso")),
        tree_glasso=json.dumps(per_step(cold_steps, "tree_glasso")))
    log("path_steps", max_comp=json.dumps([int(r.screen.max_comp) for r in warm]),
        n_components=json.dumps([int(r.screen.n_components) for r in warm]),
        dtheta_vs_cold=json.dumps([float(f"{d:.3g}") for d in diffs]),
        kkt=json.dumps([float(f"{k:.3g}") for k in kkts]),
        solve_s=json.dumps([round(r.stages()["solve"], 4) for r in warm]),
        dispatch_s=json.dumps([round(r.stages()["dispatch"], 4) for r in warm]))
    del cold, shared
    return dict(S=S, lams=lams, opts=opts, warm=warm, launches=launches,
                bcd_calls=bcd_calls, tree_calls=tree_calls, wall_warm=wall_warm)


def bucket_plain_on_cpu(task: tuple) -> tuple:
    """One recorded bucket_glasso launch through the plain version on CPU
    copies of its inputs (a worker of [path_kernels]' process pool)."""
    from repro_torch.kernels.bucket_glasso.ref import fused_bcd_ref_stack as plain

    args, kwargs = task
    torch.set_num_threads(1)
    cd = torch.empty(args[0].shape[0], dtype=torch.int64)
    theta, sweeps = plain(*args, cd_sweeps=cd, **kwargs)
    return theta, sweeps, cd


def phase_path_kernels(path: dict) -> dict:
    """Every bucket_glasso and tree_glasso launch of the [path] warm path,
    held against its plain version on CPU copies of its inputs: sweeps
    equal lane by lane (warm (W0, T0) lanes included), Theta within
    BUCKET_RTOL / TREE_RTOL; then all launches replayed in order, timed by
    CUDA events and by the profiler's device events."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    out = {}
    bcd = path["bcd_calls"]
    # copies: the pool moves what it sends into shared memory, which must
    # not be the storage of a tensor the path still holds
    tasks = [(tuple(a.to("cpu", copy=True) for a in args), dict(kw)) for args, kw, _ in bcd]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=PATH_PLAIN_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        plain = list(pool.map(bucket_plain_on_cpu, tasks, chunksize=1))
    plain_cpu_s = time.perf_counter() - t0
    err, lanes, warm_lanes = 0.0, 0, 0
    for (args, kw, (theta, sweeps)), (want, want_sw, _) in zip(bcd, plain):
        if not torch.equal(sweeps.cpu(), want_sw):
            raise AssertionError(f"[path_kernels] bucket_glasso b={args[0].shape[1]}: sweeps "
                                 f"{sweeps.tolist()} != plain {want_sw.tolist()}")
        e = float((theta.cpu() - want).abs().max())
        if not e <= BUCKET_RTOL * float(want.abs().max()):
            raise AssertionError(f"[path_kernels] bucket_glasso b={args[0].shape[1]}: "
                                 f"max|diff|={e}")
        err = max(err, e)
        T0 = args[4]
        eye = torch.eye(T0.shape[-1], dtype=T0.dtype, device=T0.device)
        warm_lanes += int((T0 != eye).flatten(1).any(dim=1).sum())
        lanes += int(T0.shape[0])
    if warm_lanes == 0:
        raise AssertionError("[path_kernels] no warm bucket_glasso lane on the path")

    def replay_bucket():
        for args, kw, _ in bcd:
            fused_bcd_stack(*args, **kw)

    ms = cuda_ms(replay_bucket, 1)
    dev = profile_calls(replay_bucket, 1, name="bucket_glasso")[1] * len(bcd)
    t_bytes = sum(4 * a[0].numel() * 8 for a, _, _ in bcd) / HBM_BYTES_PER_S * 1e3
    out["bucket_glasso"] = dict(launches=len(bcd), ms=ms, device_ms=dev, err=err,
                                bound_ms=t_bytes)
    log("path_kernels", kernel="bucket_glasso", launches=len(bcd), lanes=lanes,
        warm_lanes=warm_lanes, sizes=json.dumps(sorted({int(a[0].shape[1]) for a, _, _ in bcd})),
        sweeps_equal=True, max_abs_err=err, ms=f"{ms:.4f}", device_ms=f"{dev:.4f}",
        bytes_bound_ms=f"{t_bytes:.6f}", plain_cpu_s=f"{plain_cpu_s:.2f}",
        plain_workers=PATH_PLAIN_WORKERS)

    tree = path["tree_calls"]
    err = 0.0
    for args, _, theta in tree:
        want = glasso_forest_ref(args[0].cpu(), args[1].cpu())
        e = float((theta.cpu() - want).abs().max())
        if not e <= TREE_RTOL * float(want.abs().max()):
            raise AssertionError(f"[path_kernels] tree_glasso b={args[0].shape[1]}: max|diff|={e}")
        err = max(err, e)

    def replay_tree():
        for args, kw, _ in tree:
            glasso_forest_stack(*args, **kw)

    ms = cuda_ms(replay_tree, 1)
    dev = profile_calls(replay_tree, 1, name="tree_glasso")[1] * len(tree)
    bound = sum(tree_bound_ms(a[0].shape[0], a[0].shape[1]) for a, _, _ in tree)
    out["tree_glasso"] = dict(launches=len(tree), ms=ms, device_ms=dev, err=err, bound_ms=bound)
    log("path_kernels", kernel="tree_glasso", launches=len(tree),
        lanes=sum(int(a[0].shape[0]) for a, _, _ in tree), max_abs_err=err,
        ms=f"{ms:.4f}", device_ms=f"{dev:.4f}", ms_a_launch=f"{ms / max(len(tree), 1):.4f}",
        bound_ms=f"{bound:.6f}")
    path["bcd_calls"] = path["tree_calls"] = None
    return out


def planted_general_blocks(sizes, seed: int = 0, cross: float = 0.0) -> np.ndarray:
    """Block-diagonal S of chordless cycles (structure "general" from size
    4), dyadic entries in [0.375, 0.5], consecutive blocks coupled by
    ``cross`` (``tests/test_torch_fused.py``'s generator)."""
    rng = np.random.default_rng(seed)
    p = int(sum(sizes))
    S = np.zeros((p, p))
    off, starts = 0, []
    for b in sizes:
        starts.append(off)
        for i in range(b):
            j = (i + 1) % b
            mag = rng.integers(24, 33) / 64.0
            sgn = 1.0 if rng.random() < 0.5 else -1.0
            S[off + i, off + j] = S[off + j, off + i] = sgn * mag
        off += b
    for a, b in zip(starts, starts[1:]):
        S[a, b] = S[b, a] = cross
    np.fill_diagonal(S, 1.0)
    return S


@contextmanager
def fused_steps():
    """One dict a ``BucketExecutor.solve_plan`` call made inside the
    block: the bins its plan occupies (iterative buckets a bin fits), the
    ``solver.fused.dispatches`` it added, and every bucket_glasso call it
    made (arguments, Theta, sweeps)."""
    bcd = importlib.import_module("repro_torch.core.solvers.bcd")
    cls = importlib.import_module("repro_torch.engine.executor").BucketExecutor
    inner_solve, inner_kernel = cls.solve_plan, bcd.fused_bcd_stack
    steps: list[dict] = []

    def solving(self, plan, *args, **kwargs):
        bins = {fused_bin(b.size) for b in plan.buckets
                if route_for(b.structure) == "iterative" and b.size <= FUSED_BINS[-1]}
        before = instrument.count("solver.fused.dispatches")
        steps.append({"bins": bins, "calls": []})
        out = inner_solve(self, plan, *args, **kwargs)
        steps[-1]["dispatches"] = instrument.count("solver.fused.dispatches") - before
        return out

    def kernel(*args, **kwargs):
        theta, sweeps = inner_kernel(*args, **kwargs)
        steps[-1]["calls"].append((args, kwargs, theta, sweeps))
        return theta, sweeps

    cls.solve_plan, bcd.fused_bcd_stack = solving, kernel
    try:
        yield steps
    finally:
        cls.solve_plan, bcd.fused_bcd_stack = inner_solve, inner_kernel


def lane_sweeps(steps: list[dict]) -> dict:
    """(step, lane) -> sweeps over every bucket_glasso call of a run; a
    lane is named by its lambda and its S, W0 and T0 cut to the block's
    own size (1 + the last row with an off-diagonal entry), which the wave
    packer's re-padding leaves as they were."""
    out: dict = {}
    for k, step in enumerate(steps):
        for args, _, _, sweeps in step["calls"]:
            S, lams, _, W0, T0 = (a.detach().cpu() for a in args[:5])
            for i, sw in enumerate(sweeps.cpu().tolist()):
                off = (S[i] - torch.diag(S[i].diagonal())).abs().sum(dim=1)
                live = int(torch.nonzero(off).max()) + 1 if bool(off.any()) else 1
                h = hashlib.sha256(lams[i].numpy().tobytes())
                for x in (S[i], W0[i], T0[i]):
                    h.update(x[:live, :live].contiguous().numpy().tobytes())
                key = (k, h.hexdigest())
                out.setdefault(key, []).append(sw)
    return {k: sorted(v) for k, v in out.items()}


def same_theta(a, b) -> bool:
    """Bit-for-bit equal results (-0.0 == +0.0): dense arrays, or sparse
    ones block by block with their isolated values."""
    if isinstance(a.Theta, SparseTheta):
        if not (np.array_equal(a.Theta.isolated, b.Theta.isolated)
                and np.array_equal(a.Theta.isolated_values, b.Theta.isolated_values)):
            return False
        blocks = {np.asarray(c).tobytes(): blk for c, blk in a.Theta.blocks()}
        got = list(b.Theta.blocks())
        return len(got) == len(blocks) and all(
            np.array_equal(blocks.get(np.asarray(c).tobytes()), blk) for c, blk in got)
    return np.array_equal(a.Theta, b.Theta)


def fused_case(case: str, run, *, drop: bool) -> dict:
    """``run(fused)`` (a list of results) without and with the wave packer:
    labels, Theta and each lane's sweeps equal bit for bit at every step,
    ``solver.fused.dispatches`` equal to the occupied bins a step, and
    fewer (``drop``) or at most as many bucket_glasso launches."""
    arms = {}
    for fused in (False, True):
        torch.cuda.synchronize()
        for prefix in ("kernels.", "solver.fused."):
            instrument.reset(prefix)
        with fused_steps() as steps:
            t0 = time.perf_counter()
            res = run(fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        arms[fused] = dict(res=res, steps=steps, wall=wall,
                           launches=instrument.count("kernels.bucket_glasso.launches"),
                           counts=instrument.tail_counts("solver.fused."),
                           dispatch_s=sum(r.stages()["dispatch"] for r in res))
    un, fu = arms[False], arms[True]
    if len(un["res"]) != len(fu["res"]) or len(un["steps"]) != len(fu["steps"]):
        raise AssertionError(f"[fused] {case}: the arms ran different steps")
    for k, (a, b) in enumerate(zip(un["res"], fu["res"])):
        if not np.array_equal(a.labels, b.labels) or a.route_mix != b.route_mix:
            raise AssertionError(f"[fused] {case} step {k}: labels or route mix differ")
        if not same_theta(a, b):
            raise AssertionError(f"[fused] {case} step {k}: Theta differs from the unfused bits")
    sw_un, sw_fu = lane_sweeps(un["steps"]), lane_sweeps(fu["steps"])
    if sw_un != sw_fu:
        raise AssertionError(f"[fused] {case}: lane sweeps differ ({len(sw_un)} vs "
                             f"{len(sw_fu)} lanes)")
    bins = [len(st["bins"]) for st in fu["steps"]]
    dispatches = [st["dispatches"] for st in fu["steps"]]
    if dispatches != bins or any(st["dispatches"] for st in un["steps"]):
        raise AssertionError(f"[fused] {case}: dispatches {dispatches} != occupied bins {bins}")
    if not (fu["launches"] < un["launches"] if drop else fu["launches"] <= un["launches"]):
        raise AssertionError(f"[fused] {case}: bucket_glasso launches {un['launches']} -> "
                             f"{fu['launches']}")
    for arm in (un, fu):
        # each arm's bucket_glasso launches replayed in order: CUDA-event ms
        # and the profiler's device ms, beside the bytes bound
        calls = [c for st in arm["steps"] for c in st["calls"]]

        def replay(calls=calls):
            for args, kw, _, _ in calls:
                fused_bcd_stack(*args, **kw)

        arm["ms"] = cuda_ms(replay, 1)
        arm["device_ms"] = profile_calls(replay, 1, name="bucket_glasso")[1] * len(calls)
        arm["bound_ms"] = sum(4 * c[0][0].numel() * c[0][0].element_size()
                              for c in calls) / HBM_BYTES_PER_S * 1e3
    log("fused", case=case, steps=len(fu["steps"]), lanes=sum(len(v) for v in sw_fu.values()),
        labels_equal=True, theta_equal=True, sweeps_equal=True,
        bucket_glasso_launches_unfused=un["launches"], bucket_glasso_launches_fused=fu["launches"],
        dispatches_per_step=json.dumps(dispatches), occupied_bins_per_step=json.dumps(bins),
        fused_counts=json.dumps(fu["counts"], sort_keys=True),
        wall_unfused_s=f"{un['wall']:.4f}", wall_fused_s=f"{fu['wall']:.4f}",
        dispatch_unfused_s=f"{un['dispatch_s']:.4f}", dispatch_fused_s=f"{fu['dispatch_s']:.4f}",
        kernel_ms_unfused=f"{un['ms']:.4f}", kernel_ms_fused=f"{fu['ms']:.4f}",
        device_ms_unfused=f"{un['device_ms']:.4f}", device_ms_fused=f"{fu['device_ms']:.4f}",
        bytes_bound_ms_unfused=f"{un['bound_ms']:.6f}",
        bytes_bound_ms_fused=f"{fu['bound_ms']:.6f}")
    out = dict(case=case, steps=fu["steps"])
    for key in ("launches", "wall", "dispatch_s", "ms", "device_ms", "bound_ms"):
        out[f"{key}_unfused"], out[f"{key}_fused"] = un[key], fu[key]
    return out


def phase_fused(S_main: np.ndarray, lam_main: float, path: dict) -> dict:
    """The wave packer (``EngineOptions(fused=True)``) against the unfused
    dispatch on the planted case, [main]'s host-screen solve and [path]'s
    grid (``fused_case``); every fused launch of the planted case replayed
    through the plain version on CPU copies, sweeps equal lane by lane."""
    t_phase = time.perf_counter()
    P = planted_general_blocks(FUSED_SIZES, seed=1, cross=FUSED_LAM)
    cases = [
        fused_case(f"planted sizes={list(FUSED_SIZES)} lam={FUSED_LAM}",
                   lambda f: [glasso(P, FUSED_LAM, options=EngineOptions(fused=f))], drop=True),
        fused_case("main structured K={} p1={} lam={}".format(*MAIN_CASE, lam_main),
                   lambda f: [glasso(S_main, lam_main, options=EngineOptions(fused=f))],
                   drop=False),
        fused_case(f"path p={path['S'].shape[0]} lams={len(path['lams'])}",
                   lambda f: glasso_path(path["S"], path["lams"],
                                         options=path["opts"].replace(fused=f)), drop=True),
    ]
    calls = [c for st in cases[0]["steps"] for c in st["calls"]]
    t0 = time.perf_counter()
    err = 0.0
    for args, kw, theta, sweeps in calls:
        want, want_sw = fused_bcd_ref_stack(*(a.cpu() for a in args), **kw)
        if not torch.equal(sweeps.cpu(), want_sw):
            raise AssertionError(f"[fused] planted b={args[0].shape[1]}: sweeps "
                                 f"{sweeps.tolist()} != plain {want_sw.tolist()}")
        e = float((theta.cpu() - want).abs().max())
        if not e <= BUCKET_RTOL * float(want.abs().max()):
            raise AssertionError(f"[fused] planted b={args[0].shape[1]}: max|diff|={e}")
        err = max(err, e)
    log("fused_plain", case="planted", launches=len(calls),
        sizes=json.dumps([int(c[0][0].shape[1]) for c in calls]),
        lanes=sum(int(c[0][0].shape[0]) for c in calls), sweeps_equal=True,
        max_abs_err=err, plain_cpu_s=f"{time.perf_counter() - t0:.2f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    for c in cases:
        del c["steps"]
    return {"cases": cases, "planted_max_abs_err": err}


def phase_path_from_data(X: np.ndarray) -> dict:
    """``glasso_path(X=..., from_data=True)`` on [from_data]'s workload over
    PATH_FD_GRID: one streamed screen (one covgram_screen call) for the
    whole grid, every step's partition equal to the card's dense one, KKT
    at every step."""
    n, p = X.shape
    lams = [float(v) for v in np.linspace(*PATH_FD_GRID)]
    S_dev = sample_covariance(X)
    S = S_dev.cpu().numpy()
    smax = float(np.abs(S).max())
    dense = []
    for lam in lams:
        labels, margin = dense_partition(S_dev, lam)
        if margin < MARGIN_RTOL * smax:
            raise AssertionError(f"[path_from_data] an |S_ij| lies within {margin} of {lam}")
        dense.append(labels)
    del S_dev
    torch.cuda.empty_cache()
    opts = EngineOptions(output="sparse", solver_opts={"tol": 1e-9})
    stream = {"tile": FROM_DATA_TILE, "chunk": CHUNK}
    torch.cuda.synchronize()
    for prefix in ("kernels.", "stream.", "select.warm.", "router.fallback."):
        instrument.reset(prefix)
    with record_calls("repro_torch.stream.path", "stream_screen") as screens:
        t0 = time.perf_counter()
        res = glasso_path(X=X, lambdas=lams, from_data=True, stream=stream, options=opts)
        wall = time.perf_counter() - t0
    launches = instrument.tail_counts("kernels.")
    if len(screens) != 1 or launches.get("covgram_screen.launches", 0) <= 0:
        raise AssertionError(f"[path_from_data] {len(screens)} screens, {launches}")
    kkts = []
    for r, labels in zip(res, dense):
        if not np.array_equal(r.labels, labels):
            raise AssertionError(f"[path_from_data] lam={r.lam}: partition differs from the dense one")
        kkt = kkt_residual_sparse(S, r.Theta, r.lam)
        if not kkt <= KKT_RTOL * smax:
            raise AssertionError(f"[path_from_data] lam={r.lam}: KKT {kkt} > {KKT_RTOL}*max|S|")
        kkts.append(kkt)
    counters = instrument.counts("stream.")
    log("path_from_data", n=n, p=p, lams=json.dumps([round(v, 4) for v in lams]),
        tile=FROM_DATA_TILE, screens=len(screens),
        covgram_screen_launches=launches.get("covgram_screen.launches", 0),
        launches=json.dumps(launches, sort_keys=True),
        max_comp=json.dumps([int(r.screen.max_comp) for r in res]),
        n_components=json.dumps([int(r.screen.n_components) for r in res]),
        warm_counts=json.dumps(instrument.tail_counts("select.warm."), sort_keys=True),
        fallbacks=json.dumps(instrument.tail_counts("router.fallback."), sort_keys=True),
        kkt_max=max(kkts), max_abs_S=smax,
        tiles_total=counters.get("stream.tiles_total", 0),
        edges_emitted=counters.get("stream.edges_emitted", 0), wall_s=f"{wall:.3f}")
    return dict(lams=lams, opts=opts, stream=stream, launches=launches)


def phase_path_oversize() -> dict:
    """[oversize]'s workload along two lambdas, GIANT_LAM and one just below
    it that crosses no |S_ij|: the giant bucket is reused and its sharded
    solve warm-starts from its own previous block."""
    S = giant_workload(GIANT_P)
    lam1 = GIANT_LAM
    w = np.abs(S[np.triu_indices(S.shape[0], 1)])
    if (w == lam1).any():
        raise AssertionError("[path_oversize] an |S_ij| equals GIANT_LAM")
    lam2 = 0.5 * (lam1 + float(w[w < lam1].max()))
    opts = EngineOptions(solver="admm", oversize_threshold=GIANT_THRESHOLD,
                         solver_opts=SOLVER_OPTS)
    torch.cuda.synchronize()
    for prefix in ("kernels.", "solver.oversize.", "router.", "select.warm.", "planner."):
        instrument.reset(prefix)
    sharded = "repro_torch.core.solvers.sharded"
    with record_results(sharded, "glasso_sharded") as solves, launches_per_solve() as steps:
        t0 = time.perf_counter()
        res = glasso_path(S, [lam1, lam2], options=opts)
        wall = time.perf_counter() - t0
    warm_counts = instrument.tail_counts("select.warm.")
    planner = instrument.tail_counts("planner.")
    if len(solves) != 2 or [c[1].get("Theta0") is not None for c in solves] != [False, True]:
        raise AssertionError(f"[path_oversize] {len(solves)} sharded solves; expected a cold "
                             "then a warm one")
    for r in res:
        if r.route_mix.get("oversize", 0) != 1 or r.oversize.get("dispatched") != 1 \
                or r.oversize.get("fallbacks") != 0:
            raise AssertionError(f"[path_oversize] lam={r.lam}: {r.route_mix} {r.oversize}")
    kkts = [check_solution(S, r.lam, r) for r in res]
    iters = [c[2].iters for c in solves]
    if not iters[1] < iters[0]:
        raise AssertionError(f"[path_oversize] outer iterations {iters}: no fewer when warm")
    if planner.get("buckets_reused", 0) < 1 or warm_counts.get("reused", 0) < 1:
        raise AssertionError(f"[path_oversize] giant bucket not reused: {planner} {warm_counts}")
    log("path_oversize", p=GIANT_P, b=solves[0][2].b, lams=f"{lam1:.6g},{lam2:.10g}",
        outer_iters=json.dumps(iters), inner_iters=json.dumps([c[2].inner_iters for c in solves]),
        kkt_inplace=json.dumps([c[2].kkt_residual for c in solves]),
        kkt=json.dumps(kkts), shard_prox_launches=json.dumps(per_step(steps, "shard_prox")),
        solve_s=json.dumps([round(r.stages()["solve"], 3) for r in res]),
        warm_counts=json.dumps(warm_counts, sort_keys=True),
        planner=json.dumps(planner, sort_keys=True), wall_s=f"{wall:.3f}")
    return dict(launches=per_step(steps, "shard_prox"))


def phase_select(path: dict, X: np.ndarray, fd: dict) -> None:
    """``select_path`` with EBIC on [path]'s workload (its selected index
    must be the argmin of ``ebic_score`` over [path]'s results), then k-fold
    CV and StARS from [path_from_data]'s X and grid."""
    S, lams, opts = path["S"], path["lams"], path["opts"]
    instrument.reset("select.")
    t0 = time.perf_counter()
    sel = select_path(S, grid=lams, criterion="ebic", n=SELECT_N, options=opts)
    wall = time.perf_counter() - t0
    src = CovSource(S=S)
    scores = [ebic_score(r, src, SELECT_N) for r in path["warm"]]
    rep = sel.report
    if rep.selected_index != int(np.argmin(scores)):
        raise AssertionError(f"[select] EBIC picked {rep.selected_index}, "
                             f"argmin over [path] is {int(np.argmin(scores))}")
    score_diff = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rep.scores, scores))
    log("select", criterion="ebic", p=S.shape[0], n=SELECT_N, lams=len(lams),
        selected_index=rep.selected_index, selected_lam=f"{rep.selected_lam:.6g}",
        max_rel_score_diff_vs_path=f"{score_diff:.3g}",
        warm_fraction=f"{rep.warm_fraction:.4f}", warm=json.dumps(rep.warm, sort_keys=True),
        wall_s=f"{wall:.3f}", path_wall_s=f"{path['wall_warm']:.3f}")
    for criterion, copts in (("cv", {"k": 3, "seed": 0}),
                             ("stars", {"n_subsamples": STARS_SUBSAMPLES, "seed": 0})):
        t0 = time.perf_counter()
        sel = select_path(X=X, grid=fd["lams"], criterion=criterion, criterion_opts=copts,
                          options=fd["opts"], stream=fd["stream"])
        wall = time.perf_counter() - t0
        rep = sel.report
        if not np.isfinite(rep.scores).all():
            raise AssertionError(f"[select] {criterion}: scores {rep.scores}")
        if criterion == "cv" and rep.scores[rep.selected_index] != max(rep.scores):
            raise AssertionError(f"[select] cv picked {rep.selected_index}: {rep.scores}")
        if criterion == "stars":
            mono = rep.detail["monotone"]
            if any(a > b for a, b in zip(mono, mono[1:])):
                raise AssertionError(f"[select] stars instability not monotone: {mono}")
        log("select", criterion=criterion, p=X.shape[1], n=X.shape[0], lams=len(fd["lams"]),
            opts=json.dumps(copts, sort_keys=True), selected_index=rep.selected_index,
            selected_lam=f"{rep.selected_lam:.6g}",
            scores=json.dumps([float(f"{v:.6g}") for v in rep.scores]),
            warm_fraction=f"{rep.warm_fraction:.4f}", warm=json.dumps(rep.warm, sort_keys=True),
            wall_s=f"{wall:.3f}")


def sparse_diff(ta: SparseTheta, tb: SparseTheta) -> float:
    """max |Theta_a - Theta_b| over the blocks and isolated values of two
    SparseThetas of one partition, matched by component; a component of b
    that a lacks raises."""
    by_comp = {np.asarray(c).tobytes(): blk for c, blk in ta.blocks()}
    worst = 0.0
    for c, blk in tb.blocks():
        worst = max(worst, float(np.abs(by_comp[np.asarray(c).tobytes()] - blk).max()))
    iso_a = dict(zip(ta.isolated.tolist(), ta.isolated_values.tolist()))
    for i, v in zip(tb.isolated.tolist(), tb.isolated_values.tolist()):
        worst = max(worst, abs(iso_a[i] - v))
    return worst


def class_views(theta) -> list:
    """The single-class SparseThetas of a result: itself, or a joint
    result's class views."""
    if isinstance(theta, SparseTheta):
        return [theta]
    return [theta.class_view(k) for k in range(theta.K)]


def theta_digest(theta) -> str:
    """The first 16 hex digits of the sha256 of a sparse result's
    component ids, blocks and isolated values (every class of a joint
    result), or of a dense Theta's bytes: two results with one digest hold
    the same bits."""
    h = hashlib.sha256()
    if isinstance(theta, np.ndarray):
        h.update(np.ascontiguousarray(theta).tobytes())
        return h.hexdigest()[:16]
    for view in class_views(theta):
        for comp, blk in view.blocks():
            h.update(np.ascontiguousarray(comp).tobytes())
            h.update(np.ascontiguousarray(blk).tobytes())
        h.update(np.ascontiguousarray(view.isolated_values).tobytes())
    return h.hexdigest()[:16]


def held_to_direct(kind: str, served, direct, rtol: float) -> dict:
    """A served sparse result against its direct solve: labels and route
    mix equal, Theta within ``rtol`` max|Theta|; returns the error and both
    digests."""
    if not np.array_equal(np.asarray(served.labels), np.asarray(direct.labels)):
        raise AssertionError(f"[serve_glasso] {kind}: labels differ from the direct solve")
    if served.route_mix != direct.route_mix:
        raise AssertionError(f"[serve_glasso] {kind}: route mix {served.route_mix} != "
                             f"{direct.route_mix}")
    if isinstance(direct.Theta, np.ndarray):  # append_rows: the server's output
        err = float(np.abs(served.Theta - direct.Theta).max())
        scale = float(np.abs(direct.Theta).max())
    else:
        views_a, views_b = class_views(served.Theta), class_views(direct.Theta)
        err = max(sparse_diff(a, b) for a, b in zip(views_a, views_b))
        scale = max(max((float(np.abs(blk).max()) for _, blk in v.blocks()), default=0.0)
                    for v in views_b)
        scale = max([scale] + [float(np.abs(v.isolated_values).max()) for v in views_b
                               if v.isolated.size])
    if not err <= rtol * scale:
        raise AssertionError(f"[serve_glasso] {kind}: max|Theta - direct| {err} > "
                             f"{rtol}*{scale}")
    return dict(err=err, digest=theta_digest(served.Theta),
                digest_direct=theta_digest(direct.Theta))


def kkt_sparse_checked(kind: str, S, res) -> float:
    """The KKT residual of a sparse result block by block (its
    cross-component zeros hold by construction; a dense Theta on the card),
    at most KKT_RTOL max|S|."""
    if isinstance(res.Theta, np.ndarray):
        kkt = float(kkt_residual(torch.as_tensor(S, device=DEV),
                                 torch.as_tensor(res.Theta, device=DEV), res.lam))
    else:
        kkt = kkt_residual_sparse(S, res.Theta, res.lam)
    smax = float(np.abs(S).max())
    if not kkt <= KKT_RTOL * smax:
        raise AssertionError(f"[serve_glasso] {kind}: KKT residual {kkt} > {KKT_RTOL}*{smax}")
    return kkt


def joint_kkt_sparse(Ss: list, res, *, penalty: str) -> float:
    """The joint KKT residual of a sparse joint result, component by
    component (``joint_kkt_residual`` on the K blocks) and at the isolated
    vertices, at most KKT_RTOL max|S|."""
    from repro_torch.joint import joint_kkt_residual

    views = class_views(res.Theta)
    worst = 0.0
    for blocks in zip(*(list(v.blocks()) for v in views)):
        comp = np.asarray(blocks[0][0])
        ix = np.ix_(comp, comp)
        worst = max(worst, joint_kkt_residual(
            [S[ix] for S in Ss], np.stack([blk for _, blk in blocks]), res.lam1, res.lam2,
            penalty=penalty))
    for S, v in zip(Ss, views):
        if v.isolated.size:
            worst = max(worst, float(np.abs(1.0 / v.isolated_values
                                            - S[v.isolated, v.isolated] - res.lam1).max()))
    smax = max(float(np.abs(S).max()) for S in Ss)
    if not worst <= KKT_RTOL * smax:
        raise AssertionError(f"[serve_glasso] joint: KKT residual {worst} > {KKT_RTOL}*{smax}")
    return worst


def phase_serve_glasso(S_main: np.ndarray, X_fd: np.ndarray, joint_fd: dict,
                       path_case: tuple) -> dict:
    """``GlassoServer`` on the card with default engine options: 12 requests
    of four kinds from SERVE_GLASSO_THREADS threads at once, each asking for
    a sparse result (``RequestMeta(output="sparse")``, so no (p, p) copy is
    assembled or compared), every result held to its direct solve on the
    card; then one synchronous coalesced batch of the 8 dense requests,
    planned from their direct solves' labels, against the sum of their
    direct solves' launches.  Returns the counters and launch counts it
    printed."""
    import threading

    from repro_torch.launch.control_plane import (
        DataSpec, DenseSpec, JointSpec, PathSpec, RequestMeta)
    from repro_torch.launch.serve_glasso import GlassoRequest, GlassoServer
    from repro_torch.obs.metrics import REGISTRY

    opts = EngineOptions()
    sparse = EngineOptions(output="sparse")
    stream = {"tile": FROM_DATA_TILE, "chunk": CHUNK}
    dense = [(S_main, lam) for lam in SERVE_GLASSO_LAMS]
    dense += [(structured_synthetic(*MAIN_CASE, seed=seed), SCREEN_LAM)
              for seed in SERVE_GLASSO_SEEDS]
    path_S, path_lams = path_case
    Xs, Ss = joint_fd["Xs"], joint_fd["Ss"]
    specs = [("dense", DenseSpec(S, lam)) for S, lam in dense]
    specs += [("data", DataSpec(X_fd, FROM_DATA_LAM, session="s", stream=stream)),
              ("data", DataSpec(X_fd, FROM_DATA_LAM, stream=stream)),
              ("path", PathSpec(S=path_S, grid=path_lams, criterion="ebic", n=SELECT_N)),
              ("joint", JointSpec(Xs=Xs, lam1=JOINT_LAM1, lam2=JOINT_LAM2, penalty="group",
                                  stream=stream))]
    # thread t submits requests t, t + 4, t + 8: two dense and one other each
    futures: list = [None] * len(specs)
    walls: list = [None] * len(specs)
    errors: list[BaseException] = []
    for prefix in ("serve.", "kernels.", "stream.", "joint.", "select."):
        instrument.reset(prefix)
    REGISTRY.reset("serve.request_seconds")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GlassoServer(options=opts, max_delay=SERVE_GLASSO_WINDOW) as server:
        def client(t: int) -> None:
            try:
                for i in range(t, len(specs), SERVE_GLASSO_THREADS):
                    t_sub = time.perf_counter()
                    fut = server.submit(specs[i][1], meta=RequestMeta(tenant=f"client{t}",
                                                                      output="sparse"))
                    fut.add_done_callback(
                        lambda _f, i=i, t_sub=t_sub: walls.__setitem__(
                            i, time.perf_counter() - t_sub))
                    futures[i] = fut
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_GLASSO_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"[serve_glasso] a client failed: {errors}")
        served = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        threaded = instrument.counts("serve.")
        threaded_launches = instrument.tail_counts("kernels.")
        quantiles = {q: REGISTRY.quantile("serve.request_seconds", q) for q in (0.5, 0.99)}
        t_app = time.perf_counter()
        Y = workload(FROM_DATA_P, load=0.9, noise=0.44, seed=99)[:SERVE_APPEND_ROWS]
        instrument.reset("stream.")
        appended = server.append_rows("s", Y).result(timeout=600)
        append_wall = time.perf_counter() - t_app
        append_counts = instrument.counts("stream.")

        # the direct solves on the card, each with its own launch counts
        direct_launches: dict[str, int] = {}
        direct_dispatches = 0
        direct_dense = []
        for S, lam in dense:
            instrument.reset("kernels.")
            instrument.reset("executor.")
            direct_dense.append(glasso(S, lam, options=sparse))
            for k, v in instrument.tail_counts("kernels.").items():
                direct_launches[k] = direct_launches.get(k, 0) + v
            direct_dispatches += instrument.count("executor.dispatches")

        # one coalesced batch of the 8 dense requests, planned from the
        # direct solves' labels as the server plans a screened request,
        # the launch counters zeroed just before and read just after
        batch = []
        for (S, lam), ref in zip(dense, direct_dense):
            plan, _ = build_plan_incremental(S, lam, ref.labels, oversize=server.oversize)
            batch.append(GlassoRequest(S=S, lam=lam, labels=ref.labels, stats=ref.screen,
                                       plan=plan, output="sparse"))
        instrument.reset("serve.")
        instrument.reset("kernels.")
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        server.solve_batch(batch)
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - t_b
        batch_counts = instrument.counts("serve.")
        batch_launches = instrument.tail_counts("kernels.")
        batch_results = [r.future.result(timeout=0) for r in batch]

    checks = []
    for i, ((S, lam), res, ref) in enumerate(zip(dense, served, direct_dense)):
        held = held_to_direct(f"dense {i}", res, ref, SERVE_THETA_RTOL)
        held["kkt"] = kkt_sparse_checked(f"dense {i}", S, res)
        held["batch_digest"] = held_to_direct(f"dense {i} (batch)", batch_results[i], ref,
                                              SERVE_THETA_RTOL)["digest"]
        checks.append(("dense", i, held))
    data_direct = glasso(X=X_fd, lam=FROM_DATA_LAM, from_data=True, stream=stream,
                         options=sparse)
    S_fd = sample_covariance(X_fd).cpu().numpy()
    for i in (8, 9):
        held = held_to_direct(f"data {i - 8}", served[i], data_direct, SERVE_THETA_RTOL)
        held["kkt"] = kkt_sparse_checked(f"data {i - 8}", S_fd, served[i])
        checks.append(("data", i, held))
    del S_fd
    # append_rows answers in the server's own output ("auto": dense here)
    X2 = np.vstack([X_fd, Y])
    append_direct = glasso(X=X2, lam=FROM_DATA_LAM, from_data=True, stream=stream,
                           options=opts)
    held = held_to_direct("append", appended, append_direct, SERVE_APPEND_RTOL)
    held["kkt"] = kkt_sparse_checked("append", sample_covariance(X2).cpu().numpy(), appended)
    checks.append(("append", 12, held))
    offline = select_path(path_S, grid=path_lams, criterion="ebic", n=SELECT_N, options=opts,
                          output="sparse")
    sel = served[10]
    if (sel.report.scores != offline.report.scores
            or sel.report.selected_index != offline.report.selected_index
            or sel.report.lambdas != offline.report.lambdas):
        raise AssertionError("[serve_glasso] path: the served selection differs from "
                             "select_path")
    held = held_to_direct("path", sel.result, offline.result, 0.0)
    if held["digest"] != held["digest_direct"]:
        raise AssertionError("[serve_glasso] path: Theta's digest differs from select_path's")
    held["kkt"] = kkt_sparse_checked("path", path_S, sel.result)
    checks.append(("path", 10, held))
    joint_direct = joint_glasso(Xs=Xs, lam1=JOINT_LAM1, lam2=JOINT_LAM2, penalty="group",
                                stream=stream, options=sparse)
    held = held_to_direct("joint", served[11], joint_direct, SERVE_THETA_RTOL)
    held["kkt"] = joint_kkt_sparse(Ss, served[11], penalty="group")
    checks.append(("joint", 11, held))

    for kind, i, held in checks:
        extra = {}
        if "batch_digest" in held:
            extra["batch_digest_equal"] = held["batch_digest"] == held["digest_direct"]
        log("serve_glasso_check", kind=kind, request=i,
            wall_s=f"{walls[i]:.3f}" if i < len(walls) else f"{append_wall:.3f}",
            max_abs_err=held["err"], digest=held["digest"],
            digest_equal=held["digest"] == held["digest_direct"], kkt=held["kkt"], **extra)
    by_kind: dict[str, list] = {}
    for (kind, _), w in zip(specs, walls):
        by_kind.setdefault(kind, []).append(w)
    if batch_counts.get("serve.coalesced_blocks", 0) <= 0:
        raise AssertionError(f"[serve_glasso] the batch coalesced nothing: {batch_counts}")
    if batch_counts.get("serve.dispatches", 0) >= direct_dispatches:
        raise AssertionError(f"[serve_glasso] the batch dispatched {batch_counts} against "
                             f"{direct_dispatches} direct dispatches")
    for name in ("tree_glasso", "bucket_glasso", "covgram_screen", "joint_prox"):
        if threaded_launches.get(f"{name}.launches", 0) <= 0:
            raise AssertionError(f"[serve_glasso] {name} was not launched by the server")
    log("serve_glasso", requests=len(specs), threads=SERVE_GLASSO_THREADS,
        window_s=SERVE_GLASSO_WINDOW, wall_s=f"{wall:.3f}",
        wall_by_kind=json.dumps({k: [round(w, 3) for w in v] for k, v in by_kind.items()}),
        request_seconds_p50=quantiles[0.5], request_seconds_p99=quantiles[0.99],
        dispatches=threaded.get("serve.dispatches", 0),
        batches=threaded.get("serve.batches", 0),
        coalesced_blocks=threaded.get("serve.coalesced_blocks", 0),
        fastpath_requests=threaded.get("serve.fastpath_requests", 0),
        serve=json.dumps(threaded, sort_keys=True),
        launches=json.dumps(threaded_launches, sort_keys=True))
    log("serve_glasso_append", rows=SERVE_APPEND_ROWS, wall_s=f"{append_wall:.3f}",
        tiles_revalidated=append_counts.get("stream.tiles_revalidated", 0),
        tiles_rescreened=append_counts.get("stream.tiles_rescreened", 0),
        components_touched=append_counts.get("stream.session_components_touched", 0))
    log("serve_glasso_batch", dense_requests=len(dense), wall_s=f"{batch_wall:.3f}",
        dispatches=batch_counts.get("serve.dispatches", 0),
        coalesced_blocks=batch_counts.get("serve.coalesced_blocks", 0),
        direct_dispatches=direct_dispatches,
        tree_glasso_launches=batch_launches.get("tree_glasso.launches", 0),
        tree_glasso_launches_direct=direct_launches.get("tree_glasso.launches", 0),
        bucket_glasso_launches=batch_launches.get("bucket_glasso.launches", 0),
        bucket_glasso_launches_direct=direct_launches.get("bucket_glasso.launches", 0),
        launches=json.dumps(batch_launches, sort_keys=True),
        launches_direct=json.dumps(direct_launches, sort_keys=True))
    return dict(threaded=threaded, launches=threaded_launches, batch=batch_counts,
                batch_launches=batch_launches, direct_launches=direct_launches)

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    fa = phase_flash_attention()
    big_cc = in_background(structured_synthetic, *THRESHOLD_CC_CASES[1])
    phase_card_tests()
    phase_tree()
    phase_bucket()

    S = structured_synthetic(*MAIN_CASE, seed=0)
    lam = SCREEN_LAM
    name = "structured K={} p1={}".format(*MAIN_CASE)
    launches, host_res = solve_on_card(name, S, lam)
    solve_on_card(name + " (repeat)", S, lam)
    for name in ("tree_glasso", "bucket_glasso"):
        if launches.get(f"{name}.launches", 0) <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    tree, bucket = main_path_kernels(S, lam)

    P = paper_synthetic(*PAPER_CASE, seed=0)
    lo, hi = lambda_interval_for_k(P, PAPER_CASE[0])
    paper_launches, _ = solve_on_card(
        "paper_synthetic K={} p1={} lambda_I".format(*PAPER_CASE), P, 0.5 * (lo + hi))
    if paper_launches.get("bucket_glasso.launches", 0) <= 0:
        raise AssertionError("bucket_glasso was not launched on the Table-1 shape")

    log_main_kernels(tree, bucket)

    phase_threshold_cc([lambda: S, big_cc])
    screen_launches, thr = phase_screen(S, lam, host_res)
    pg_launches, pg_kept = phase_solver("pg", S, lam, host_res)
    admm_launches, admm_kept = phase_solver("admm", S, lam, host_res)
    sp_admm = shard_prox_on_path(admm_kept)
    if not any(len(sh) == 4 and sh[1] > 1 for sh in sp_admm["shapes"]):
        raise AssertionError(f"[admm] no stacked shard_prox launch checked: {sp_admm['shapes']}")
    log_shard_prox("admm", sp_admm, admm_launches)
    del admm_kept
    pl = prox_l1_on_path(pg_kept)
    log_prox_l1(pl)
    del pg_kept
    X_fd = workload(FROM_DATA_P, load=0.9, noise=0.44)
    X_st = workload(STREAM_P, load=0.75, noise=0.66)
    cov_f32 = phase_covgram_screen(X_fd, X_st)
    fd_launches, cov = phase_from_data(X_fd)
    phase_stream(X_st)
    phase_from_data_sparse(X_st)
    del X_st
    path = phase_path()
    path_kernels = phase_path_kernels(path)
    fused = phase_fused(S, lam, path)
    fd_path = phase_path_from_data(X_fd)
    phase_select(path, X_fd, fd_path)
    path_case = (path["S"], path["lams"])
    del path
    cg = phase_covgram()
    ls_launches, large = phase_large_scale()

    joint_launches, joint_prox = phase_joint("joint", JOINT_CASE, "group", JOINT_ROUTES)
    _, fused_prox = phase_joint("joint_fused", JOINT_FUSED_CASE, "fused", JOINT_FUSED_ROUTES)
    joint_fd = phase_joint_from_data()
    sg = phase_serve_glasso(S, X_fd, joint_fd, path_case)
    del X_fd, joint_fd, path_case
    jp = {}
    for label, recorded, penalty in (("joint", joint_prox, "group"),
                                     ("joint_fused", fused_prox, "fused")):
        jp[label] = joint_prox_on_path(recorded, penalty=penalty, label=label)
        r = jp[label]
        log("joint_prox", path=label, penalty=penalty, launches_timed=r["n"],
            shapes=json.dumps(r["shapes"]), max_abs_err_z=r["err_z"],
            max_abs_err_u=r["err_u"], rel_err_rp2=r["rel_rp2"], rel_err_rd2=r["rel_rd2"],
            ms=f"{r['ms']:.4f}", device_ms=f"{r['device_ms']:.4f}",
            host_ms=f"{r['host_ms']:.4f}", ms_a_launch=f"{r['ms'] / max(r['n'], 1):.4f}",
            plain_ms=f"{r['plain_ms']:.4f}", bound_ms=f"{r['bound_ms']:.6f}",
            ms_f32=f"{r['ms_f32']:.4f}", device_events_per_call=json.dumps(r["events"]))
    oversize_launches, sp_kept, giant = phase_oversize()
    md = phase_multidevice(large, giant, S, lam, host_res)
    del large, giant
    oversize_path = phase_path_oversize()
    sp = shard_prox_on_path(sp_kept)
    log_shard_prox("oversize", sp, oversize_launches)
    del sp_kept
    phase_f32(S, lam, host_res)
    phase_joint_prox_k20()
    serve_launches = phase_serve()
    bf16_launches = phase_prefill_bf16()
    phase_train()
    moe_gqa = phases_moe()
    kernels = [
        {
            "name": "tree_glasso", "route": "cuda",
            "source": "src/repro_torch/csrc/tree_glasso.cu",
            "replaces": "src/repro/kernels/tree_glasso/tree_glasso.py:27",
            "launches": launches["tree_glasso.launches"],
            "max_abs_err": tree["err"], "ms": tree["ms"], "plain_ms": tree["plain_ms"],
            "bound_ms": tree["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "device_ms": tree["device_ms"], "host_ms": tree["host_ms"],
            "redesigned": "one launch a call, lam by pointer or value, "
                          "at most ceil(B / SMs) blocks a program",
            "path": path_kernels["tree_glasso"],
            # [serve_glasso]: one coalesced batch of 8 requests vs their direct solves
            "serve": {"launches": sg["batch_launches"].get("tree_glasso.launches", 0),
                      "launches_direct": sg["direct_launches"].get("tree_glasso.launches", 0)},
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
            "ns_per_step": ns_per_step(bucket["ms"], bucket["chain_sum"]),
            "redesigned": "g = W beta carried, moving coordinates found by ballot, "
                          "W in shared memory up to b = 168 (float64)",
            "path": path_kernels["bucket_glasso"],
            # the wave packer: one launch a bin, bits equal to unfused dispatch
            "fused": fused,
            "serve": {"launches": sg["batch_launches"].get("bucket_glasso.launches", 0),
                      "launches_direct": sg["direct_launches"].get("bucket_glasso.launches",
                                                                   0)},
        },
        {
            "name": "threshold_cc", "route": "cuda",
            "source": "src/repro_torch/csrc/threshold_cc.cu",
            "replaces": "src/repro/kernels/threshold_cc/threshold_cc.py:30",
            "launches": screen_launches["threshold_cc.launches"], "max_abs_err": thr["err"],
            "ms": thr["ms"], "plain_ms": thr["plain_ms"],
            "bound_ms": thr["bound_ms"], "bound_by": "bytes", "library_ms": None,
            # [multidevice]: the row-slab launch of the sharded screen (four
            # slabs of [large_scale]'s R a round)
            "multidevice": {key: md["screen"][key] for key in (
                "launches", "rounds", "shape", "ms", "plain_ms", "bound_ms", "max_abs_err")},
        },
        {
            "name": "covgram_screen", "route": "cuda",
            "source": "src/repro_torch/csrc/covgram_screen.cu",
            "replaces": "src/repro/kernels/covgram_screen/covgram_screen.py:40",
            "launches": fd_launches["covgram_screen.launches"], "max_abs_err": cov["err"],
            "ms": cov["ms"], "plain_ms": cov["plain_ms"], "bound_ms": cov["bound_ms"],
            "bound_by": "operations" if cov["ops_ms"] > cov["bytes_ms"] else "bytes",
            "library_ms": cov["library_ms"], "device_ms": cov["device_ms"],
            "redesigned": f"FP64 tensor cores (mma.sync {MMA}), cp.async three-stage ring",
            # the float32 body (FP32 FMAs) on float32 copies of [from_data]'s batch
            "float32": cov_f32,
            "path": {"launches": fd_path["launches"].get("covgram_screen.launches", 0)},
        },
        {
            "name": "joint_prox", "route": "cuda",
            "source": "src/repro_torch/csrc/joint_prox.cu",
            "replaces": "src/repro/kernels/joint_prox/joint_prox.py:36",
            "launches": joint_launches["joint_prox.launches"],
            "max_abs_err": max(jp["joint"]["err_z"], jp["joint"]["err_u"]),
            "ms": jp["joint"]["ms"], "plain_ms": jp["joint"]["plain_ms"],
            "bound_ms": jp["joint"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "device_ms": jp["joint"]["device_ms"], "host_ms": jp["joint"]["host_ms"],
            "redesigned": "one launch a call (last-block ticket), lean wrapper",
        },
        {
            "name": "prox_l1", "route": "cuda",
            "source": "src/repro_torch/csrc/prox_l1.cu",
            "replaces": "src/repro/kernels/prox_l1/prox_l1.py:26",
            "launches": pg_launches["prox_l1.launches"], "max_abs_err": pl["err"],
            "ms": pl["ms"], "plain_ms": pl["plain_ms"], "bound_ms": pl["bound_ms"],
            "bound_by": "bytes", "library_ms": pl["library_ms"],
            "device_ms": pl["device_ms"], "host_ms": pl["host_ms"],
            "redesigned": "one launch a call, t and lam by pointer or value",
        },
        {
            "name": "shard_prox", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_prox.cu",
            "replaces": "src/repro/kernels/shard_prox/shard_prox.py:27",
            "launches": oversize_launches["shard_prox.launches"],
            "max_abs_err": max(sp["err"], sp_admm["err"]),
            "ms": sp["ms"], "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
            "bound_by": "bytes", "library_ms": sp["library_ms"],
            "path": {"launches": sum(oversize_path["launches"]),
                     "per_step": oversize_path["launches"]},
            # [multidevice]: the giant block at d = MULTI_D, a launch a shard
            "multidevice": md["oversize"],
        },
        {
            "name": "covgram", "route": "cuda",
            "source": "src/repro_torch/csrc/covgram.cu",
            "replaces": "src/repro/kernels/covgram/covgram.py:29",
            "launches": ls_launches["covgram.launches"],
            "max_abs_err": cg["err"], "ms": cg["ms"], "plain_ms": cg["plain_ms"],
            "bound_ms": cg["bound_ms"], "bound_by": cg["bound_by"],
            "library_ms": cg["library_ms"], "device_ms": cg["device_ms"],
            "host_ms": cg["host_ms"],
            "redesigned": "persistent 128 x 128 tiles, 8 x 8 a thread, loads of the next "
                          "chunk under the FMAs, TMA stores under the next tile's FMAs",
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:32",
            "launches": serve_launches["flash_attention.launches"],
            "max_abs_err": fa["err"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
            "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
            "library_ms": fa["library_ms"], "device_ms": fa["device_ms"],
            "redesigned": "float32: register-tiled FP32 FMAs, swizzled float4 shared loads, "
                          "cp.async K/V ring; bf16: wgmma fed by TMA",
            # head dims 192 and 256 (float32 and bf16) at the prefill's length
            "wide": fa.get("wide", {}),
            # [serve_moe_gqa]: qwen3-moe's prefill at 24 of its 48 layers
            "moe_gqa": {"launches": moe_gqa["launches"]["flash_attention.launches"],
                        "device_ms_per_prefill": moe_gqa["flash_device_ms"],
                        **{key: fa["moe_gqa"][key] for key in (
                            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")},
                        "max_abs_err": fa["moe_gqa"]["err"]},
            # the bf16 instance (the wgmma body) on [prefill_bf16]'s path
            "bf16": {
                "launches": bf16_launches["flash_attention.wgmma_launches"],
                **{key: fa["bf16"][key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")},
                "max_abs_err": fa["bf16"]["err"],
            },
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
