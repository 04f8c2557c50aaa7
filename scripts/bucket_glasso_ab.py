"""Time several checkouts' ``bucket_glasso`` against each other in ONE
process, on the same inputs, in alternating turns.

    git archive <parent> | tar -x -C build/parent      # a checkout to compare
    python3 scripts/bucket_glasso_ab.py --tree parent=build/parent --tree change=. \\
        --rounds 40 --out chiprun_out/ab.txt           # on the card
    python3 scripts/bucket_glasso_ab.py --plain --tree parent=build/parent --tree change=.

On the card (the default), each checkout's ``csrc/bucket_glasso.cu`` is
compiled alone into ``build/ab/<label>.so`` with the port's nvcc flags (all
compiles started together), and its float64 entry point is launched on the
stacks that the main case's dense plan hands ``bucket_glasso``
(``structured_synthetic(250, 24)``, p = 6000, lam = 0.6: the
``chip_smoke.py`` ``[main]`` solve), with the cold pair the solve builds.
A round runs the labels in the order given and then reversed (ABBA); a
turn launches every stack ``--reps`` times between two CUDA events.  The
script prints, per label, the median, min and max of its turns' ms for
one pass over the stacks, per pair of labels the median of the per-round
differences and the rounds each won, and fails unless every label gives
the same sweeps and Theta within 1e-9 of the first label's.

With ``--plain``, each checkout's plain version
(``kernels/bucket_glasso/ref.py``) runs on the CPU, one thread, on cold
stacks of 8 lanes at b = 8, 16, 32 and 64 in float64 and float32; it
prints the least of ``--reps`` runs a label and case.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.screening import thresholded_components  # noqa: E402
from repro_torch.core.solvers.bcd import convergence_scale  # noqa: E402
from repro_torch.covariance import structured_synthetic  # noqa: E402
from repro_torch.engine.planner import build_plan_incremental  # noqa: E402
from repro_torch.engine.registry import route_for  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = (_I, [_P] * 9 + [_I] * 4 + [ctypes.c_double, _I, _P])


def csrc(tree: Path) -> Path:
    return tree / "src" / "repro_torch" / "csrc"


def compile_all(trees: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """Each tree's bucket_glasso.cu alone as a shared library, compiled
    side by side."""
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kbuild.nvcc()
    procs = {}
    for label, tree in trees.items():
        so = out / f"{label}.so"
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-shared", str(csrc(tree) / "bucket_glasso.cu"),
               "-o", str(so)]
        procs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.bucket_glasso_launch_f64
        fn.restype, fn.argtypes = _LAUNCH
        lib.bucket_glasso_scratch_values.restype = ctypes.c_longlong
        lib.bucket_glasso_scratch_values.argtypes = [_I, _I]
        libs[label] = lib
    return libs


def main_stacks(dev) -> list[tuple]:
    """(S, lams, scales, W0, T0) of every iterative bucket of the main
    case's dense plan, cold pairs, on ``dev``."""
    S = structured_synthetic(250, 24, seed=0)
    lam = 0.6
    labels, _ = thresholded_components(S, lam)
    plan, _ = build_plan_incremental(S, lam, labels)
    stacks = []
    for bk in plan.buckets:
        if route_for(bk.structure) != "iterative":
            continue
        blocks = torch.as_tensor(bk.blocks, device=dev)
        n, b = blocks.shape[0], blocks.shape[1]
        lams = torch.full((n,), lam, dtype=torch.float64, device=dev)
        eye = torch.eye(b, dtype=torch.float64, device=dev)
        stacks.append((blocks, lams, convergence_scale(blocks),
                       (blocks + lams[:, None, None] * eye).contiguous(),
                       eye.expand(n, b, b).contiguous()))
    return stacks


def launcher(lib: ctypes.CDLL, stacks: list[tuple]):
    """A function that launches ``lib``'s kernel once on every stack, and
    the outputs it writes."""
    outs = []
    for S, lams, scales, W0, T0 in stacks:
        N, b = S.shape[0], S.shape[1]
        values = lib.bucket_glasso_scratch_values(b, 8)
        outs.append((torch.empty_like(S), torch.empty(N, dtype=torch.int32, device=S.device),
                     torch.empty(max(N * values, 1), dtype=S.dtype, device=S.device)))

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for (S, lams, scales, W0, T0), (theta, sweeps, scratch) in zip(stacks, outs):
            status = lib.bucket_glasso_launch_f64(
                S.data_ptr(), lams.data_ptr(), scales.data_ptr(), W0.data_ptr(),
                T0.data_ptr(), theta.data_ptr(), sweeps.data_ptr(), None,
                scratch.data_ptr(), S.shape[0], S.shape[1], 100, 100, 1e-6, 1, stream)
            if status != 0:
                raise RuntimeError(f"bucket_glasso launch failed: status {status}")

    return run, outs


def card(trees: dict[str, Path], rounds: int, reps: int, lines: list[str]) -> None:
    dev = torch.device("cuda")
    libs = compile_all(trees)
    stacks = main_stacks(dev)
    lines.append("stacks " + " ".join(f"{tuple(s[0].shape)}" for s in stacks))
    runs = {}
    first = None
    for label, lib in libs.items():
        run, outs = launcher(lib, stacks)
        run()
        torch.cuda.synchronize()
        runs[label] = run
        if first is None:
            first = outs
            continue
        for (t0, s0, _), (t1, s1, _) in zip(first, outs):
            if not torch.equal(s0, s1):
                raise AssertionError(f"{label}: sweeps {s1.tolist()} != {s0.tolist()}")
            err = float((t0 - t1).abs().max())
            if not err <= 1e-9 * float(t0.abs().max()):
                raise AssertionError(f"{label}: max|dTheta| {err}")
            lines.append(f"{label}: sweeps equal, max|dTheta| vs first {err:.3e}")
    order = list(trees)
    ms = {label: [] for label in order}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for label in order + order[::-1]:
            start.record()
            for _ in range(reps):
                runs[label]()
            end.record()
            end.synchronize()
            ms[label].append(start.elapsed_time(end) / reps)
    for label in order:
        v = ms[label]
        lines.append(f"{label}: median {statistics.median(v):.5f} min {min(v):.5f} "
                     f"max {max(v):.5f} ms a pass over the stacks ({len(v)} turns of {reps})")
    base = order[0]
    for label in order[1:]:
        # per round: the mean of a label's two turns against the base's
        pair = [(a1 + a2) / 2 - (b1 + b2) / 2
                for a1, a2, b1, b2 in zip(ms[label][0::2], ms[label][1::2],
                                          ms[base][0::2], ms[base][1::2])]
        wins = sum(d < 0 for d in pair)
        lines.append(f"{label} - {base}: median {statistics.median(pair):+.5f} ms "
                     f"({100 * statistics.median(pair) / statistics.median(ms[base]):+.2f} %), "
                     f"{label} faster in {wins} of {len(pair)} rounds")


def plain(trees: dict[str, Path], reps: int, lines: list[str]) -> None:
    torch.set_num_threads(1)
    mods = {}
    for label, tree in trees.items():
        path = tree / "src" / "repro_torch" / "kernels" / "bucket_glasso" / "ref.py"
        spec = importlib.util.spec_from_file_location(f"ab_ref_{label}", path)
        mods[label] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[label])
    for dtype in (torch.float64, torch.float32):
        for b in (8, 16, 32, 64):
            rng = np.random.default_rng(b)
            N = 8
            covs = [np.cov(rng.standard_normal((2 * b + 5, b)), rowvar=False) for _ in range(N)]
            S = torch.as_tensor(np.stack(covs)).to(dtype)
            off = np.abs(covs[0][np.triu_indices(b, 1)])
            lams = torch.full((N,), float(np.quantile(off, 0.7)), dtype=dtype)
            eye = torch.eye(b, dtype=dtype)
            args = (S, lams, convergence_scale(S), S + lams[:, None, None] * eye,
                    eye.expand(N, b, b))
            best = {label: float("inf") for label in mods}
            sweeps = {}
            for _ in range(reps):
                for label, mod in mods.items():
                    t0 = time.perf_counter()
                    _, sw = mod.fused_bcd_ref_stack(*args)
                    best[label] = min(best[label], time.perf_counter() - t0)
                    sweeps[label] = sw.tolist()
            same = len({tuple(v) for v in sweeps.values()}) == 1
            lines.append(f"plain {str(dtype).removeprefix('torch.')} b={b} N={N} "
                         + " ".join(f"{k}={v:.4f}s" for k, v in best.items())
                         + f" sweeps {'equal' if same else sweeps}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="LABEL=DIR",
                    help="a checkout holding src/repro_torch (repeatable; the first is the base)")
    ap.add_argument("--plain", action="store_true", help="the plain versions on the CPU")
    ap.add_argument("--rounds", type=int, default=30, help="ABBA rounds on the card")
    ap.add_argument("--reps", type=int, default=None,
                    help="passes a turn on the card (default 20), runs a case with --plain "
                         "(default 3)")
    ap.add_argument("--out", type=Path, help="file that receives every line")
    args = ap.parse_args()
    trees = {k: (ROOT / v).resolve() for k, v in (t.split("=", 1) for t in args.tree)}
    lines: list[str] = []
    if args.plain:
        plain(trees, args.reps or 3, lines)
    else:
        if not torch.cuda.is_available():
            print("bucket_glasso_ab: CUDA is not available", file=sys.stderr)
            return 1
        card(trees, args.rounds, args.reps or 20, lines)
    print("\n".join(lines), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
