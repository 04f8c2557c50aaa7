"""LR schedules."""

import math

import torch


def cosine_with_warmup(peak: float, *, warmup: int = 100, total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down to
    ``floor * peak`` at ``total``.  ``lr(step)`` is a float32 0-d tensor on
    the step's device, computed in float32 as the reference computes it
    (a float32 step, float32 cos): Python floats would round
    differently."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * (step + 1) / warmup
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr
