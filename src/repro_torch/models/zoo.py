"""Building a model (`build_model`) and counting its parameters."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class Model:
    """A config and its ``DecoderLM``; the parameters live in ``net``."""

    cfg: ArchConfig
    net: tfm.DecoderLM

    @property
    def device(self) -> torch.device:
        return self.net.device

    def init(self, seed: int = 0) -> None:
        self.net.init_params(seed)

    def prefill(self, batch: dict, *, capacity=None, use_flash=None):
        return tfm.prefill(self.net, batch, capacity=capacity, use_flash=use_flash)

    def decode_step(self, token, caches, pos):
        return tfm.decode_step(self.net, token, caches, pos)


def build_model(cfg: ArchConfig, *, device="cuda") -> Model:
    """The config's model with its parameters allocated, uninitialised, on
    ``device`` (``Model.init`` draws them there); ``"meta"`` allocates
    nothing."""
    return Model(cfg=cfg, net=tfm.DecoderLM(cfg, device=device))


def count_params(model: Model | nn.Module) -> int:
    """Parameter count of a ``Model`` or an ``nn.Module`` (shapes only: a
    model on the meta device counts without allocating)."""
    net = model.net if isinstance(model, Model) else model
    return int(sum(p.numel() for p in net.parameters()))
