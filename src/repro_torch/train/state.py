"""Train state: float32 master parameters, optimizer state, step counter."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.tree import tree_map


@dataclass
class TrainState:
    """``step`` a 0-d int32 tensor; ``params`` the float32 master copy in
    the reference's stacked tree (``transformer.init_params``);
    ``opt_state`` the optimizer's tree.  The train step updates
    ``params`` and ``opt_state`` in place."""

    step: torch.Tensor
    params: dict
    opt_state: dict


def init_state(model, optimizer: Optimizer, seed: int = 0, *, device=None) -> tuple[TrainState, dict]:
    """(state, specs) with parameters drawn from ``seed`` on ``device``
    (the model's device by default; a model built on the meta device for
    training holds no parameters of its own, so name one)."""
    dev = model.device if device is None else tfm.resolve_device(device)
    params, specs = tfm.init_params(model.cfg, seed=seed, device=dev)
    master = tree_map(lambda p: p.to(torch.float32), params)
    return (
        TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=master,
            opt_state=optimizer.init(master),
        ),
        specs,
    )


def state_specs(specs: dict, optimizer_name: str = "adamw") -> dict:
    """Logical-axis specs for the whole TrainState (m and v mirror the
    parameters; the reference resolves adafactor's factored leaves at
    placement time)."""
    return {"step": (), "params": specs, "opt_state": {"m": specs, "v": specs}}
