"""Wave packer: cross-bucket megabatching for the fused bucket BCD.

The planner's lifetime bucketing is what makes warm starts exact: every
(size, structure, membership) gets its own bucket, so a component's
previous padded solution can follow it along a lambda path.  The price is
dispatch fragmentation: one step of a p = 2400 path can carry many
iterative buckets of a handful of small blocks each, one ``bucket_glasso``
launch apiece.  This module re-packs every fused-eligible iterative bucket
of one plan step, across bucket boundaries, into size-binned stacks and
solves each bin with ONE ``bucket_glasso`` launch.

Bitwise contract (``tests/test_torch_fused.py``; on the card
``chip_smoke.py``'s ``[fused]`` phase):

* **Bin re-padding is exact.**  Re-padding an (s, s) padded block into a
  (bin, bin) slot with an identity diagonal changes no lane's bits: the
  padded columns are eq.-(10)-screened no-ops, the cross region stays
  exactly zero, every sum of the kernel and of its plain version adds the
  same terms in the same order with exact zeros appended, and the zeros
  drop out of every maximum.  The one quantity that would change is the
  convergence scale ``mean|S - diag S|`` (denominator s^2 against bin^2),
  so it is computed at the SOURCE shape (``bucket_scales``, the unfused
  solve's own call) and the kernel takes it as a per-lane input.
* **Warm and cold lanes share one launch.**  Cold lanes carry the pair the
  solver would have built itself, W0 = S + lam*I and Theta0 = I, so one
  launch mixes warm and cold source buckets.
* **No launch depends on its batch size.**  Each lane of the kernel is one
  thread block, and every batched operation of the plain version is
  elementwise or a reduction over one lane, so a lane's bits are the same
  alone or in a megabatch.  The reference's ``min_batch2`` (XLA
  specializes a unit batch dimension) has nothing to guard here.
"""

from __future__ import annotations

import functools

import torch

#: padded megabatch sizes spanning the small iterative tail; a block bigger
#: than the last bin is not fused-eligible
FUSED_BINS = (8, 16, 32, 64)


def fused_bin(size: int) -> int | None:
    """Smallest bin that fits ``size``, or None (too big to fuse)."""
    for b in FUSED_BINS:
        if size <= b:
            return b
    return None


def bucket_scales(stacked: torch.Tensor) -> torch.Tensor:
    """Per-lane convergence scale at the SOURCE bucket shape:
    ``core.solvers.bcd.convergence_scale``, the call the unfused solve
    makes on the same stack (so the same bits)."""
    from repro_torch.core.solvers.bcd import convergence_scale

    return convergence_scale(stacked)


def repad_stack(stack: torch.Tensor, bin_: int, diag) -> torch.Tensor:
    """(n, s, s) -> (n, bin, bin): zero border, ``diag`` on the padded
    diagonal.  diag=1.0 re-pads S/Theta stacks (identity padding, matching
    ``blocks.pad_block``); diag=1+lam re-pads W stacks (the diagonal KKT of
    the padded coordinates, matching ``BucketExecutor._warm_stack``)."""
    n, s, _ = stack.shape
    if s == bin_:
        return stack
    out = torch.zeros((n, bin_, bin_), dtype=stack.dtype, device=stack.device)
    out.diagonal(dim1=1, dim2=2)[:, s:] = diag
    out[:, :s, :s] = stack
    return out


def compiled_fused_solver(bin_: int, dtype, opts_key: tuple):
    """The fused megabatch solver for one (bin, dtype, opts), the
    reference's signature: fn(blocks, lams, scales, W0, T0) -> (Theta,
    sweeps).  torch compiles nothing, so it is ``fused_bcd_stack`` with the
    options bound, the same for every bin and dtype; the executor calls
    ``fused_bcd_stack`` itself."""
    from repro_torch.core.solvers import bcd

    del bin_, dtype
    return functools.partial(bcd.fused_bcd_stack, **dict(opts_key))
