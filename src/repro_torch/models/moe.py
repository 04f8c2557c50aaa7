"""Mixture-of-experts FFN with top-k routing (GShard/Switch semantics), the
port of the reference's ``models/moe.py``.

    MoE(d_model, n_experts=, d_ff_expert=, n_shared=, d_ff_shared=, ...)
    moe_apply(p, x, n_experts=, top_k=, capacity_factor=, dropless=, chunk=)
        -> (out, aux)

The leaves are the reference's: ``router.w`` (D, E), always float32
whatever the config's dtype; the stacked expert SwiGLU weights ``wi`` and
``wg`` (E, D, F) and ``wo`` (E, F, D) as bare tensors; and an optional
always-on ``shared`` SwiGLU of width ``n_shared * d_ff_shared``
(DeepSeek-V2's shared experts).

Routing is the reference's: router logits from x in float32, softmax,
top-k with ties going to the lower expert index (``lax.top_k``'s rule:
a stable descending sort, since ``torch.topk`` promises no order among
ties), the gates renormalised to sum to 1.  Tokens route in chunks of
``Tc = min(chunk, T)`` with the last chunk zero-padded.  A (token, choice)
pair keeps its slot when its rank among the chunk's pairs of its expert,
counted in token-major order ``t * k + j``, is below the capacity C
(``C = Tc`` when dropless, so nothing drops).

The dispatch is another form of the same function.  The reference builds
one-hot dispatch and combine tensors (n, Tc, k, E, C) and runs every expert
on all C slots, E / k times the real work when dropless.  Here one stable
sort groups the kept pairs by expert (``kept_pairs``), each expert's SwiGLU
runs on its own rows with ``torch.matmul``, and each token gathers its k
outputs back through the inverse permutation and sums them in choice
order j = 0..k-1: no (.., E, C) tensor, no atomics in the combine.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Dense, SwiGLU, _param, acc_dtype, swiglu, truncnorm_


class MoE(nn.Module):
    """The router, the stacked routed experts and the optional shared
    SwiGLU of one MoE FFN."""

    def __init__(self, d_model: int, *, n_experts: int, d_ff_expert: int, n_shared: int = 0,
                 d_ff_shared: int = 0, dtype, device):
        super().__init__()
        self.router = Dense(d_model, n_experts, dtype=torch.float32, device=device)
        self.wi = _param((n_experts, d_model, d_ff_expert), dtype, device)
        self.wg = _param((n_experts, d_model, d_ff_expert), dtype, device)
        self.wo = _param((n_experts, d_ff_expert, d_model), dtype, device)
        self.shared = (SwiGLU(d_model, n_shared * d_ff_shared, dtype=dtype, device=device)
                       if n_shared else None)

    def reset(self, generator: torch.Generator | None) -> None:
        """The reference's scales: d_model**-0.5 for the router, wi and wg,
        d_ff_expert**-0.5 for wo."""
        self.router.reset(generator)
        d_model, d_ff = self.wi.shape[1], self.wi.shape[2]
        truncnorm_(self.wi, d_model**-0.5, generator)
        truncnorm_(self.wg, d_model**-0.5, generator)
        truncnorm_(self.wo, d_ff**-0.5, generator)
        if self.shared is not None:
            self.shared.reset(generator)


def top_k_stable(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower
    index, as ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(Tc: int, *, n_experts: int, top_k: int, capacity_factor: float,
             dropless: bool) -> int:
    """Slots per expert per chunk (the reference's C)."""
    if dropless:
        return Tc
    return int(min(Tc, max(1, (Tc * top_k * capacity_factor) // n_experts)))


def route(p: MoE, xt: torch.Tensor, *, top_k: int):
    """xt: (N, D) -> (probs (N, E), gates (N, k), expert ids (N, k)): the
    softmax of the float32 router logits, its top k, the gates
    renormalised."""
    acc = acc_dtype(xt.dtype)
    probs = torch.softmax(xt.to(acc) @ p.router.w.to(acc), dim=-1)
    gates, idx = top_k_stable(probs, top_k)
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def kept_pairs(idx: torch.Tensor, *, n_chunks: int, n_experts: int, cap: int):
    """idx: (n_chunks * Tc, k) expert ids -> (kept, counts).  ``kept`` holds
    the flat pair ids ``t * k + j`` of the pairs within capacity, grouped by
    expert and, within an expert, by chunk and token-major order;
    ``counts[e]`` (a host list) is how many of them expert e has.

    One stable sort on ``expert * n_chunks + chunk`` lines up each
    (expert, chunk) group in token-major order, so a pair's rank in its
    group is its position less the group's start."""
    N = idx.numel()
    experts = idx.reshape(-1)
    # 0..N-1 serves twice: as the pair ids, then as the sorted positions
    pos = torch.arange(N, device=idx.device)
    key = experts * n_chunks + pos // (N // n_chunks)
    order = torch.sort(key, stable=True).indices
    sizes = torch.bincount(key, minlength=n_experts * n_chunks)
    starts = torch.cumsum(sizes, 0) - sizes
    key_sorted = key[order]
    keep = (pos - starts[key_sorted]) < cap
    kept = order[keep]
    counts = torch.bincount(key_sorted[keep] // n_chunks, minlength=n_experts)
    return kept, counts.tolist()


def moe_apply(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, dropless: bool = False, chunk: int = 1024):
    """x: (B, S, D) -> (out (B, S, D), aux), the reference's ``moe_apply``.

    ``dropless=True`` (serving) gives every expert a whole chunk of slots,
    so no pair drops and prefill and decode route alike; training runs the
    fixed-capacity regime.  ``aux`` is the Switch load-balance loss over
    the real tokens: E * sum(mean probs * mean choice counts)."""
    B, S, D = x.shape
    T, k = B * S, top_k
    xt = x.reshape(T, D)
    Tc = min(chunk, T)
    pad = (-T) % Tc
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, D))])
    n_chunks = xt.shape[0] // Tc
    probs, gates, idx = route(p, xt, top_k=k)
    cap = capacity(Tc, n_experts=n_experts, top_k=k, capacity_factor=capacity_factor,
                   dropless=dropless)
    kept, counts = kept_pairs(idx, n_chunks=n_chunks, n_experts=n_experts, cap=cap)

    # each expert's SwiGLU on its own rows, the experts in order
    xs = xt[kept // k]
    ys, start = [], 0
    for e, n in enumerate(counts):
        if n:
            ys.append(swiglu(xs[start:start + n], p.wi[e], p.wg[e], p.wo[e]))
            start += n
    # a zero row last: the dropped pairs gather it
    ys.append(xs.new_zeros((1, D)))
    ys = torch.cat(ys)
    inv = torch.full((idx.numel(),), kept.numel(), dtype=torch.long, device=x.device)
    inv[kept] = torch.arange(kept.numel(), device=x.device)
    y_pairs = ys[inv].view(-1, k, D)

    acc = acc_dtype(x.dtype)
    g = gates.to(x.dtype).to(acc)
    yt = g[:, 0, None] * y_pairs[:, 0].to(acc)
    for j in range(1, k):
        yt = yt + g[:, j, None] * y_pairs[:, j].to(acc)
    out = yt[:T].to(x.dtype).reshape(B, S, D)
    if p.shared is not None:
        out = out + p.shared(x)

    me = probs[:T].mean(dim=0)
    frac = torch.bincount(idx[:T].reshape(-1), minlength=n_experts).to(me.dtype) / T
    aux = n_experts * torch.sum(me * frac)
    return out, aux
