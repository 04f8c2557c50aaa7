"""Serving entry point: batched prefill + greedy decode of one architecture,
float32, with random parameters drawn from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \
        --full --batch 4 --prompt-len 2048 --new-tokens 16

Without ``--full`` the architecture's ``reduced()`` config runs.  The
default device is ``cuda``: prefill's self-attention then runs the
``flash_attention`` kernel.  ``--device cpu`` runs the plain-PyTorch
versions; without CUDA the default raises instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_arch
from repro_torch.data.specs import make_batch
from repro_torch.models.transformer import resolve_device
from repro_torch.models.zoo import Model, build_model, count_params
from repro_torch.train.serving import greedy_generate


@dataclass
class Serving:
    """One serving run: the generated tokens (B, new_tokens), the model and
    the prompt batch it served, and its measurements."""

    tokens: torch.Tensor
    model: Model
    batch: dict
    n_params: int
    init_s: float
    prefill_s: float
    decode_s: float
    decode_steps: int

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens per second of prefill plus decode."""
        return self.tokens.numel() / (self.prefill_s + self.decode_s)


def run_serving(*, arch: str | ArchConfig, batch: int, prompt_len: int, new_tokens: int,
                reduced: bool = True, seed: int = 0, device="cuda", log=print) -> Serving:
    """Serve ``arch`` (a name, or a config such as a depth cut of one) in
    float32: build and initialise the model, then greedy-generate from a
    random prompt batch."""
    dev = resolve_device(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = count_params(model)
    log(f"arch={cfg.name} params={n_params:,} device={dev}")

    shape = ShapeConfig("serve_cli", seq_len=prompt_len, global_batch=batch, kind="prefill")
    batch_data = make_batch(cfg, shape, seed=seed, device=dev)

    stats: dict = {}
    with torch.inference_mode():
        tokens = greedy_generate(model, batch_data, max_new_tokens=new_tokens, stats=stats)
    run = Serving(tokens=tokens, model=model, batch=batch_data, n_params=n_params,
                  init_s=init_s, **stats)
    log(f"generated {tuple(tokens.shape)}: prefill {run.prefill_s:.3f}s, decode "
        f"{run.decode_s:.3f}s ({run.tokens_per_s:.1f} tok/s incl. prefill)")
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run_serving(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, reduced=not args.full, seed=args.seed,
                device=args.device)


if __name__ == "__main__":
    main()
