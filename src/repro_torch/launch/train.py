"""Training entry point with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --steps 20 --batch 4 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --full --steps 6 --batch 2 --seq 512

Without ``--full`` the architecture's ``reduced()`` config runs; the
configuration runs in float32, as in the reference.  The default device
is ``cuda``; ``--device cpu`` runs on the CPU, and without CUDA the
default raises instead.  No hand-written kernel is on this path:
attention trains through the plain ``_sdpa`` (``_sdpa_chunked`` above
4096 tokens) under autograd, as the reference trains outside its Pallas
kernels.

Fault tolerance:
  * ``--resume`` restarts from the newest complete checkpoint (atomic
    LATEST pointer), and because the data is a pure function of (seed,
    step) it reproduces the trajectory bit for bit;
  * SIGTERM/SIGINT trigger a final synchronous checkpoint and a clean
    return ("preempted"); the previous handlers are restored on the way
    out;
  * each step's wall seconds feed an EWMA, and a step above three times it
    is logged as a straggler.

``grad_compress`` is accepted and unused, as in the reference; the
reference's adafactor run raises ``TypeError`` (it hands the schedule, a
function, to an optimizer that multiplies by its ``lr``), and so does
this one.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np


def run_training(
    *,
    arch: str,
    steps: int,
    batch: int,
    seq: int,
    reduced: bool = True,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = False,
    microbatches: int = 1,
    optimizer_name: str = "adamw",
    lr: float = 3e-4,
    seed: int = 0,
    grad_compress: bool = False,
    log=print,
    device="cuda",
):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.models.transformer import resolve_device
    from repro_torch.models.zoo import build_model, count_params
    from repro_torch.optim import OPTIMIZERS, cosine_with_warmup
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    shape = ShapeConfig("train_cli", seq_len=seq, global_batch=batch, kind="train")

    # the net on the meta device: the parameters live in the state's tree
    model = build_model(cfg, device="meta")
    optimizer = OPTIMIZERS[optimizer_name](
        cosine_with_warmup(lr, warmup=max(10, steps // 20), total=steps)
    )
    state, _specs = init_state(model, optimizer, seed, device=dev)
    log(f"arch={cfg.name} reduced={reduced} params={count_params(state.params):,}")

    mgr = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    start_step = 0
    if resume and mgr is not None:
        try:
            state, start_step = mgr.restore_latest(state)
            log(f"resumed from step {start_step}")
        except FileNotFoundError:
            log("no checkpoint found; cold start")

    step_fn = make_train_step(model, optimizer, microbatches=microbatches, remat="none")
    data = SyntheticLM(cfg, shape, seed=seed, device=dev)

    # preemption: save on SIGTERM/SIGINT, then return cleanly
    interrupted = {"flag": False}

    def _on_signal(signum, frame):
        interrupted["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _on_signal)
    old_int = signal.signal(signal.SIGINT, _on_signal)

    ewma, losses = None, []
    try:
        for step in range(start_step, steps):
            batch_data = data.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_data)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            straggler = dt > 3.0 * ewma and step > start_step + 3
            losses.append(loss)
            if step % 10 == 0 or straggler:
                log(
                    f"step {step:5d} loss {loss:.4f} {dt*1e3:7.1f} ms"
                    + ("  [STRAGGLER]" if straggler else "")
                )
            if mgr is not None and mgr.should_save(step):
                mgr.save(int(state.step), state)
            if interrupted["flag"]:
                log(f"preemption signal at step {step}; checkpointing")
                if mgr is not None:
                    mgr.save(int(state.step), state, blocking=True)
                return state, losses, "preempted"
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        if mgr is not None:
            mgr.wait()

    if mgr is not None:
        mgr.save(int(state.step), state, blocking=True)
    return state, losses, "done"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    state, losses, status = run_training(
        arch=args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=not args.full, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, microbatches=args.microbatches,
        optimizer_name=args.optimizer, lr=args.lr, seed=args.seed, device=args.device,
    )
    print(f"status={status} final_step={int(state.step)} "
          f"loss[first5]={np.round(losses[:5], 3).tolist()} "
          f"loss[last5]={np.round(losses[-5:], 3).tolist()}")


if __name__ == "__main__":
    main()
