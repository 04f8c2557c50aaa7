"""Plain PyTorch version of the ``covgram`` kernel:

    S = (X - mu)'(X - mu) / n        in float32, n the true row count

X of any floating dtype is cast to float32 first (bf16 upcasts exactly),
mu is the float32 column mean, and the product is one float32 matrix
product — the reference's ``covgram_ref`` operation for operation.
"""

from __future__ import annotations

import torch


def covgram_ref(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    return (xc.T @ xc) / n
