"""The step functions of the launcher.

train_step: gradient accumulation over microbatches (compute in
``cfg.dtype``, float32 gradient accumulators), a remat policy on every
layer, then one optimizer update of the float32 master parameters, in
place.  serve steps: thin prefill and decode_step wrappers.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TORCH_DTYPES
from repro_torch.train.state import TrainState
from repro_torch.train.tree import leaves, tree_map

_aten = torch.ops.aten
# a product without batch dimensions: x @ W (B * S rows against a weight)
_DOTS_NO_BATCH = {_aten.mm.default, _aten.addmm.default}
# attention's scores and weighted sums carry batch and head dimensions
_DOTS = _DOTS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}


def nothing_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_dots_with_no_batch_dims(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_NO_BATCH
            else CheckpointPolicy.PREFER_RECOMPUTE)


# The reference's names for jax.checkpoint_policies: "full" recomputes the
# whole layer in the backward pass (torch.utils.checkpoint around it);
# "dots" keeps the outputs of every matrix product, "dots_no_batch" those of
# the products without batch dimensions (the weight products), and
# recomputes the rest.
REMAT_POLICIES = {
    "none": None,
    "full": nothing_saveable,
    "dots": checkpoint_dots,
    "dots_no_batch": checkpoint_dots_with_no_batch_dims,
}


def cast_params(params, dtype: torch.dtype):
    """Floating leaves in ``dtype``; a leaf already in it is returned as it
    is, not copied."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def make_train_step(
    model,
    optimizer,
    *,
    microbatches: int = 1,
    remat: str = "full",
    sharding_policy=None,
) -> Callable:
    if sharding_policy is not None:
        raise NotImplementedError(
            "sharding_policy: a mesh-sharded train step is not ported yet; it comes "
            "with the mesh slice of the LM pillar (ROADMAP queue 1)"
        )
    cfg: ArchConfig = model.cfg
    policy = REMAT_POLICIES[remat]
    compute_dtype = TORCH_DTYPES[cfg.dtype]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        n = microbatches
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        # detach() shares the master's storage: at float32 nothing is copied
        params_c = cast_params(tree_map(lambda p: p.detach(), state.params), compute_dtype)
        flat = leaves(params_c)
        for p in flat:
            p.requires_grad_(True)

        gacc, lsum = None, None
        for i in range(n):
            mb = {k: v[i] for k, v in micro.items()}
            loss, _ = model.train_loss(params_c, mb, remat_policy=policy)
            grads = torch.autograd.grad(loss, flat)
            loss = loss.detach().to(torch.float32)
            lsum = loss if lsum is None else lsum + loss
            if gacc is None:
                # 0 + g is g up to the sign of a zero, which no later step
                # tells apart: one microbatch keeps no second tree
                gacc = [g.to(torch.float32) for g in grads]
            else:
                for a, g in zip(gacc, grads):
                    a.add_(g.to(torch.float32))
            del grads, loss
        if n > 1:
            for a in gacc:
                a.div_(n)
        grads_tree = _unflatten(state.params, gacc)
        del params_c, flat, gacc

        with torch.no_grad():
            params, opt_state = optimizer.update(grads_tree, state.opt_state, state.params,
                                                 state.step)
        new_state = TrainState(step=state.step + 1, params=params, opt_state=opt_state)
        return new_state, {"loss": lsum / n}

    return train_step


def _unflatten(like, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def make_prefill_step(model) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(token, caches, pos):
        return model.decode_step(token, caches, pos)

    return decode_step
