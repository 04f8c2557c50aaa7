"""Building a model (`build_model`) and counting its parameters."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.train.tree import leaves


@dataclass(frozen=True)
class Model:
    """A config and its ``DecoderLM``.  Serving uses the parameters that
    live in ``net``; training passes its own stacked tree to
    ``train_loss``, and a model built on the meta device holds none."""

    cfg: ArchConfig
    net: tfm.DecoderLM

    @property
    def device(self) -> torch.device:
        return self.net.device

    def init(self, seed: int = 0) -> None:
        self.net.init_params(seed)

    def train_loss(self, params: dict, batch: dict, remat_policy=None):
        """(loss, {"loss", "aux"}) of ``batch`` under the stacked parameter
        tree ``params`` (``tfm.init_params``' layout): ``net`` runs through
        ``torch.func.functional_call``, its own parameters unused."""
        return torch.func.functional_call(
            self.net, tfm.module_state(params), (batch,), {"remat_policy": remat_policy},
            strict=True,
        )

    def prefill(self, batch: dict, *, capacity=None, use_flash=None):
        return tfm.prefill(self.net, batch, capacity=capacity, use_flash=use_flash)

    def decode_step(self, token, caches, pos):
        return tfm.decode_step(self.net, token, caches, pos)


def build_model(cfg: ArchConfig, *, device="cuda") -> Model:
    """The config's model with its parameters allocated, uninitialised, on
    ``device`` (``Model.init`` draws them there); ``"meta"`` allocates
    nothing, which is what training wants."""
    return Model(cfg=cfg, net=tfm.DecoderLM(cfg, device=device))


def count_params(model: Model | nn.Module | dict) -> int:
    """Parameter count of a ``Model``, an ``nn.Module`` or a parameter tree
    (shapes only: a model on the meta device counts without
    allocating)."""
    if isinstance(model, dict):
        tensors = leaves(model)
    else:
        tensors = (model.net if isinstance(model, Model) else model).parameters()
    return int(sum(p.numel() for p in tensors))


def count_params_abstract(cfg: ArchConfig) -> int:
    """Parameters of ``init_params``' tree, counted on the meta device."""
    return count_params(tfm.init_params(cfg, device="meta")[0])


def active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token, the N in MODEL_FLOPS = 6 * N * D: all of
    them for the dense family; for the MoE family every parameter but the
    routed experts', plus top_k experts' worth a layer (the reference's
    formula, which counts the router and the shared experts as active)."""
    total = count_params_abstract(cfg)
    if not cfg.moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    return total - cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
