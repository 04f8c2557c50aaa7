"""AdamW with decoupled weight decay.

State (m, v) is kept in float32 and mirrors the (float32 master) parameter
tree.  ``update`` works leaf by leaf and in place: the parameters and the
state are written where they lie and returned, and the gradients it is
given are consumed (clipped in place, then used as the leaf's scratch), so
a step holds no temporary the size of a leaf.  At qwen2.5-3b's width the
largest stacked leaf is 3.25 GB."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params, step) -> (params, state), in place


def _clip_scale(grads, grad_clip: float) -> torch.Tensor:
    """min(1, grad_clip / (global norm + 1e-12)), the norm's squares summed
    over the leaves in the reference's leaf order (sorted dict keys)."""
    sq = None
    for g in leaves(grads):
        s = torch.linalg.vector_norm(g).square()
        sq = s if sq is None else sq + s
    return torch.clamp(grad_clip / (torch.sqrt(sq) + 1e-12), max=1.0)


def _step_t(step) -> torch.Tensor:
    """The float32 step count t = step + 1 (the bias corrections' and the
    decay's exponent)."""
    return torch.as_tensor(step).to(torch.float32) + 1.0


def adamw(
    lr: float | Callable = 3e-4,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                              params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                              params)}

    def update(grads, state, params, step):
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        scale = _clip_scale(grads, grad_clip) if grad_clip else None
        t = _step_t(step)
        lr_t = lr_fn(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def per_leaf(g, m, v, p):
            if scale is not None:
                g.mul_(scale)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = torch.div(v, c2, out=g).sqrt_().add_(eps)        # sqrt(v_hat) + eps
            u = torch.div(m, u, out=u).div_(c1)                  # m_hat / that
            u.add_(p, alpha=weight_decay)
            p.sub_(u.mul_(lr_t))

        tree_map(per_leaf, grads, state["m"], state["v"], params)
        return params, state

    return Optimizer(init=init, update=update)
