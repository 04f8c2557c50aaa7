"""Adafactor [Shazeer & Stern 2018]: a factored second moment, O(n + m)
state for an (n, m) matrix instead of Adam's O(nm).  Every leaf of rank 2
or more is factored over its last two axes, so a stacked (L, d) norm leaf
is factored across its layers, and the update's RMS clip runs over the
whole leaf, as in the reference.  ``update`` works in place like
``adamw``'s: it consumes the gradients, and one scratch the size of the
leaf at a time holds g^2 and the denominator."""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, _step_t
from repro_torch.train.tree import tree_map


def adafactor(
    lr: float = 1e-2,
    *,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    decay_rate: float = 0.8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def per_leaf(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw),
                }
            return {"v": torch.zeros(p.shape, **kw)}

        return tree_map(per_leaf, params)

    def update(grads, state, params, step):
        t = _step_t(step)
        beta2 = 1.0 - t ** (-decay_rate)

        def per_leaf(g, s, p):
            g = g.to(torch.float32)
            g2 = torch.mul(g, g).add_(eps)
            if _factored(p.shape):
                s["vr"].mul_(beta2).add_(torch.mean(g2, dim=-1).mul_(1 - beta2))
                s["vc"].mul_(beta2).add_(torch.mean(g2, dim=-2).mul_(1 - beta2))
                vr, vc = s["vr"], s["vc"]
                denom = torch.mul(vr[..., None], vc[..., None, :], out=g2)
                denom.div_(torch.mean(vr, dim=-1, keepdim=True)[..., None]).sqrt_()
                g.div_(denom.clamp_(min=eps))
            else:
                s["v"].mul_(beta2).add_(g2.mul_(1 - beta2))
                g.div_(torch.sqrt(s["v"]))
            rms = torch.sqrt(torch.mean(torch.mul(g, g, out=g2)) + eps)
            g.div_(torch.clamp(rms / clip_threshold, min=1.0))
            decay = torch.mul(p, lr * weight_decay, out=g2)
            p.sub_(g.mul_(lr)).sub_(decay)

        tree_map(per_leaf, grads, state, params)
        return params, state

    return Optimizer(init=init, update=update)
