"""Row-sharded matrix primitives: the sharded oversize solver's vocabulary.

In the reference every operand of the sharded solver is the local
(rows_local, p) shard of a row-sharded square matrix inside a
``shard_map`` body, and these helpers are the ring matmul, the one-shard
``all_to_all`` transpose, the gathered matvec and the psum/pmax
reductions.  The port runs the one-device case (d = 1), where the whole
padded matrix is the one shard and each helper is its local operation: a
plain float64 ``torch.matmul`` (the reference leaves these products to
XLA, outside any kernel), ``.T``, ``@`` and the identity.  Several devices
on ``torch.distributed`` are a later slice of the port.
"""

from __future__ import annotations

import torch


def ring_matmul(a_rows: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A, B, C row-sharded (d = 1: the local product)."""
    return a_rows @ b_rows


def transpose_rowsharded(a_rows: torch.Tensor) -> torch.Tensor:
    """A^T row-sharded from A row-sharded (d = 1: the local transpose)."""
    return a_rows.mT


def matvec_rowsharded(a_rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(A @ v) replicated, from A row-sharded and v replicated."""
    return a_rows @ v


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the shards (d = 1: the identity)."""
    return x


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the shards (d = 1: the identity)."""
    return x


def device_memory_budget_mb(device) -> float | None:
    """The most device memory in MB that the caching allocator may hold on
    ``device``, or None on the CPU, which reports none: the planner's
    ``oversize_budget_mb="auto"`` hook.

    The reference reads its allocator's ``bytes_limit``: what XLA's device
    allocator may still hand out, not the card's total.  PyTorch's nearest
    quantity is the memory the caching allocator can reach: the bytes
    ``torch.cuda.mem_get_info`` reports free plus the bytes the allocator
    already reserves, which it reuses without a new ``cudaMalloc``.
    Other processes' memory and the CUDA context are not in it, as they are
    not in ``bytes_limit``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return float(free + torch.cuda.memory_reserved(dev)) / 2**20
