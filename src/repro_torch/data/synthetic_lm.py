"""Deterministic synthetic LM data.

  * Determinism by construction: the batch of a step is a pure function of
    (seed, step), drawn with numpy's ``default_rng((seed, step))`` in the
    reference's order, so its tokens and targets are the reference's bit
    for bit, and a restarted job regenerates exactly the stream it would
    have seen: checkpoint/restart needs no data state.
  * A background prefetch thread with a bounded queue hides generation
    latency behind the running step.

The "language" is a Zipfian unigram stream with a Markov bigram overlay:
enough structure for the loss to fall.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.specs import _token_batch_shapes
from repro_torch.models.transformer import resolve_device


class SyntheticLM:
    """Batches of ``shape`` for ``cfg`` on ``device`` (``"cuda"`` unless
    the caller asks for the CPU; without CUDA that raises)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0, prefetch: int = 2,
                 device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- pure batch function ------------------------------------------------
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        cfg, shape = self.cfg, self.shape
        shapes = _token_batch_shapes(cfg, shape, with_targets=True)
        (B, S_tok) = shapes["tokens"][0]
        # Zipf unigrams + shifted-repeat bigram structure
        base = rng.zipf(1.3, size=(B, S_tok + 1)) % cfg.vocab
        repeat = rng.random((B, S_tok + 1)) < 0.3
        seq = np.where(repeat, np.roll(base, 1, axis=1), base).astype(np.int32)
        out = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in out.items()}
        for k, (s, d) in shapes.items():
            if k in ("tokens", "targets"):
                continue
            out[k] = torch.from_numpy(rng.standard_normal(s) * 0.02).to(self.device, d)
        return out

    # -- prefetch loop ------------------------------------------------------
    def start(self, first_step: int = 0):
        def loop():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def next(self) -> dict:
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
