"""Public wrapper for the covgram_screen kernel (the CUDA kernel on the
card, the plain version on the CPU), its padding convention, and edge
compaction.

``compact_edges`` turns a batch of thresholded tiles into the compacted
(i, j, |S_ij|) edge arrays the streaming screener accumulates: an entry of
``vals`` is nonzero iff it is an eq.-(4) edge (|S_ij| > lam >= 0 implies
S_ij != 0 in the same arithmetic), so compaction is one ``torch.nonzero``
over the in-flight batch on its own device — only the compacted edges leave
the card.

A kernel call on the card with the tile indices already there as int32
tensors, as the screening paths pass them (each uploads its tile schedule
once), is one launch: the kernel writes vals, counts and stats whole, and
combines each pair's count and maxima in accumulators cached per (device,
stream) that it leaves zeroed, so no output is zero-filled first.  Calls
on one stream share a buffer because its launches run in order; each
stream has its own, and a lock keeps one thread's lookup and launch from
interleaving with another's (the server solves on its batcher thread and
on callers' threads at once)."""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from repro_torch.core.instrument import bump
from repro_torch.kernels.build import check, library
from repro_torch.kernels.covgram_screen.ref import covgram_screen_ref


def pad_for_screen(
    x: torch.Tensor, mu, *, block_n: int, block_p: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad rows to a block_n multiple with copies of mu (centered
    contribution exactly zero) and columns to a block_p multiple with zeros
    (mu padded with zeros, so padded columns contribute exact zeros).

    mu is cast to x's dtype and device FIRST and the cast copy is what both
    the padding and the returned mean use, so padded rows center to exactly
    zero."""
    n, p = x.shape
    mu = torch.as_tensor(mu).to(dtype=x.dtype, device=x.device)
    pad_n = (-n) % block_n
    pad_p = (-p) % block_p
    if pad_n:
        x = torch.cat([x, mu.expand(pad_n, p)])
    if pad_p:
        x = torch.nn.functional.pad(x, (0, pad_p))
        mu = torch.nn.functional.pad(mu, (0, pad_p))
    return x.contiguous(), mu.contiguous()


#: the kernel's mma shape (sm_90's; sm_80's m8n8k4 measured slower on the
#: H100: PERF.md section 6)
MMA = "m16n8k8"

#: (device, raw stream) -> the per-pair accumulators (count, two maxima,
#: ticket), zeroed once when allocated and left zeroed by every launch
_ACC: dict[tuple[torch.device, int], torch.Tensor] = {}
#: held from a call's accumulator lookup until its launch is enqueued
_LOCK = threading.Lock()

#: X's dtype -> the body's entry point (float64: FP64 tensor cores;
#: float32: FP32 FMAs on the CUDA cores)
_ENTRIES = {torch.float64: "covgram_screen_launch", torch.float32: "covgram_screen_launch_f32"}


def _accumulators(dev: torch.device, stream: int, npairs: int) -> torch.Tensor:
    """The cached accumulators of one stream for ``npairs`` pairs,
    reallocated only when a call needs more; called under ``_LOCK``."""
    acc = _ACC.get((dev, stream))
    if acc is None or acc.numel() < 4 * npairs:
        acc = torch.zeros(4 * npairs, dtype=torch.int64, device=dev)
        _ACC[(dev, stream)] = acc
    return acc


@functools.cache
def _launcher(entry: str):
    return getattr(library(), entry)


def covgram_screen_tiles(
    x_pad: torch.Tensor,
    mu_pad: torch.Tensor,
    i_idx,
    j_idx,
    lam: float,
    *,
    n_true: int,
    p_true: int,
    block_p: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute and threshold the requested tile pairs of the centered Gram;
    returns (vals (B, bp, bp), counts (B,) int32, stats (B, 2)) on x's
    device (stats: [tile max |S_ij|, max |S_ij| <= lam], off-diagonal).

    x_pad/mu_pad follow ``pad_for_screen``; the tile indices are sequences
    or int tensors (int32 ones on x's device are used in place, others are
    copied there).  A CPU x runs the plain version; a CUDA x launches
    ``csrc/covgram_screen.cu`` (its float64 or float32 body, by x's dtype;
    vals and stats come back in that dtype, lam compared in it) or raises.
    Each launch bumps ``kernels.covgram_screen.launches``."""
    dev = x_pad.device
    i_idx = torch.as_tensor(i_idx, dtype=torch.int32, device=dev).contiguous()
    j_idx = torch.as_tensor(j_idx, dtype=torch.int32, device=dev).contiguous()
    if dev.type == "cpu":
        return covgram_screen_ref(
            x_pad, mu_pad, i_idx, j_idx, lam,
            n_true=n_true, p_true=p_true, block_p=block_p,
        )
    if dev.type != "cuda":
        raise ValueError(f"covgram_screen: no kernel for device {dev}")
    if x_pad.dtype not in _ENTRIES or mu_pad.dtype != x_pad.dtype:
        raise TypeError(
            "covgram_screen: the CUDA kernel takes float64 or float32 x and mu of one "
            f"dtype, got {x_pad.dtype}/{mu_pad.dtype}"
        )
    N, P = x_pad.shape
    if mu_pad.shape != (P,) or mu_pad.device != dev or P % block_p:
        raise ValueError(
            f"covgram_screen: x (N, P) with P a multiple of block_p={block_p} and "
            f"mu ({P},) on {dev}; got x {tuple(x_pad.shape)}, mu {tuple(mu_pad.shape)} "
            f"on {mu_pad.device}"
        )
    if i_idx.shape != j_idx.shape or i_idx.ndim != 1:
        raise ValueError("covgram_screen: i_idx and j_idx must be equal-length vectors")
    B = i_idx.shape[0]
    x_pad, mu_pad = x_pad.contiguous(), mu_pad.contiguous()
    if x_pad.data_ptr() % 16:  # the kernel copies X in 16-byte pieces
        x_pad = x_pad.clone()
    vals = torch.empty((B, block_p, block_p), dtype=x_pad.dtype, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=x_pad.dtype, device=dev)
    if B == 0:
        return vals, counts, stats
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    other = dev.index != torch.cuda.current_device()
    with _LOCK, torch.cuda.device(dev) if other else contextlib.nullcontext():
        acc = _accumulators(dev, stream, B)
        status = _launcher(_ENTRIES[x_pad.dtype])(
            x_pad.data_ptr(), mu_pad.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(),
            vals.data_ptr(), counts.data_ptr(), stats.data_ptr(), acc.data_ptr(), B, N, P,
            block_p, int(n_true), int(p_true), float(lam), stream,
        )
    check(status, "covgram_screen")
    bump("kernels.covgram_screen.launches")
    return vals, counts, stats


def compact_edges_signed(
    vals: torch.Tensor, i_idx, j_idx, *, block_p: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global (i, j, S_ij) of every nonzero in a batch of thresholded tiles,
    upper triangle only (diagonal tile pairs hold both orientations;
    off-diagonal pairs are scheduled with tile_i < tile_j), in row-major
    order of (pair, row, col), as numpy arrays (int64, int64, float64).  The
    tile indices are sequences or int tensors, as ``covgram_screen_tiles``
    takes them."""
    dev = vals.device
    i_idx = torch.as_tensor(i_idx, device=dev).to(torch.int64)
    j_idx = torch.as_tensor(j_idx, device=dev).to(torch.int64)
    t, ri, ci = torch.nonzero(vals, as_tuple=True)
    gi = i_idx[t] * block_p + ri
    gj = j_idx[t] * block_p + ci
    keep = gi < gj
    v = vals[t[keep], ri[keep], ci[keep]].to(torch.float64)
    return gi[keep].cpu().numpy(), gj[keep].cpu().numpy(), v.cpu().numpy()


def compact_edges(
    vals: torch.Tensor, i_idx, j_idx, *, block_p: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``compact_edges_signed`` with weights |S_ij|."""
    gi, gj, v = compact_edges_signed(vals, i_idx, j_idx, block_p=block_p)
    return gi, gj, np.abs(v)


def covgram_screen_tiles_stacked(
    xs_pad,
    mus_pad,
    i_idx_per_class,
    j_idx_per_class,
    lam: float,
    *,
    n_trues,
    p_true: int,
    block_p: int,
    pair_batch: int = 64,
    tile_fn=None,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """K-stacked screen: one gram + threshold + compact pass PER CLASS.

    The joint screener's entry point: each class streams its OWN kept-tile
    schedule (the Cauchy-Schwarz certificates are per class) in bounded
    ``pair_batch`` flights through ``tile_fn`` (default
    ``covgram_screen_tiles``: the kernel on the card), and the compacted
    SIGNED per-class edges (i, j, S_ij) come back for the hybrid rule; each
    class's schedule is uploaded to x's device once, as int32.  Per-class
    row counts n_k differ, which is why this loops over classes rather than
    launching one K-batched kernel."""
    if tile_fn is None:
        tile_fn = covgram_screen_tiles
    batch = max(1, int(pair_batch))
    out = []
    for x_pad, mu_pad, bi, bj, n_true in zip(
        xs_pad, mus_pad, i_idx_per_class, j_idx_per_class, n_trues
    ):
        bi = torch.as_tensor(np.asarray(bi, np.int32), device=x_pad.device)
        bj = torch.as_tensor(np.asarray(bj, np.int32), device=x_pad.device)
        parts = []
        for b0 in range(0, bi.numel(), batch):
            sl = slice(b0, b0 + batch)
            vals, _, _ = tile_fn(
                x_pad, mu_pad, bi[sl], bj[sl], lam,
                n_true=int(n_true), p_true=p_true, block_p=block_p,
            )
            parts.append(compact_edges_signed(vals, bi[sl], bj[sl], block_p=block_p))
        out.append(
            tuple(
                np.concatenate([pt[c] for pt in parts]) if parts else np.empty(0, dt)
                for c, dt in enumerate((np.int64, np.int64, np.float64))
            )
        )
    return out
