"""Distributed screening, block solving and the row-sharded matrix
primitives, over a mesh of local devices driven from one process.

A ``DeviceMesh`` is an ordered list of ``torch.device``s, repeats allowed;
d is its size and shard k lives on ``mesh[k]``.  It is the counterpart of
the reference's single-controller ``local_device_mesh`` over
``jax.local_devices()``: the reference runs these algorithms inside
``shard_map``, here the one controller issues every shard's work itself.
A row-sharded (bp, bp) matrix is a list of d ``(bp/d, bp)`` tensors,
shard k holding rows [k bp/d, (k + 1) bp/d).  A replicated value (a
scalar, a label vector, a power-iteration vector) is one tensor on the
mesh's first device, where the reductions land, and goes to a shard's
device where the shard uses it (``replica``).

The collectives move shards with ``Tensor.to(device, non_blocking=True)``:
a peer copy between cards, in PyTorch's stream order, with no host
synchronisation.  A shard that goes to another shard is always copied
(``copy=True``), so on a mesh that repeats one card the communication is
a device-to-device copy of the same bytes; a replicated value is not
copied where it already lies.  Nothing here writes in place into a tensor
it received.

Two stages, mirroring the paper's consequences 2-4:

1. ``distributed_components``: the only stage that communicates.  S is
   row-sharded; each label-propagation round runs one ``threshold_cc``
   hook step a shard over its own rows (the kernel's row-slab launch on a
   CUDA shard, its plain version on a CPU shard), then all-gathers the p
   labels (p * 4 bytes, negligible next to the p^2/d scan).

2. ``distributed_bucket_solve``: ZERO-communication batched solves.
   Theorem 1 makes the blocks independent, so a stack of same-size padded
   blocks is split across the shards and each shard's sub-stack is solved
   on its device with no collective at all.

At d = 1 each primitive is the local operation (a product, a transpose
view, the identity), so the one-device path keeps its bits.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.instrument import bump


def _resolved(device) -> torch.device:
    """A CUDA or CPU device, a CUDA one with its index (the current one
    where none is named), so that devices compare equal to the
    ``.device`` of their tensors; a CUDA device without CUDA raises
    ``RuntimeError``, any other type ``ValueError``."""
    from repro_torch.engine.options import resolve_device  # lazy: import cycle

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh takes CUDA or CPU devices, got {dev}")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """An ordered list of local devices (CUDA or CPU, repeats allowed):
    shard k of a row-sharded operand lives on ``devices[k]``; ``size`` is
    d.  A device that repeats holds several shards (d logical shards on
    one card, or on the CPU)."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        devices = tuple(_resolved(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, k: int) -> torch.device:
        return self.devices[k]

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def as_mesh(devices) -> DeviceMesh:
    """``devices`` (a mesh, or a sequence of devices) as a ``DeviceMesh``."""
    return devices if isinstance(devices, DeviceMesh) else DeviceMesh(devices)


def local_device_mesh(device="cuda") -> DeviceMesh:
    """The default mesh of ``device``: every visible card (``cuda:0 ..
    cuda:n-1``) for ``"cuda"``, the one device for a named device
    (``"cuda:1"``, ``"cpu"``)."""
    from repro_torch.engine.options import resolve_device  # lazy: import cycle

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return DeviceMesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return DeviceMesh([dev])


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def replica(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A replicated value on ``device``: the same tensor where it already
    lies, else an asynchronous copy in stream order."""
    return x if x.device == device else x.to(device, non_blocking=True)


def send(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A shard sent to another shard's ``device``: always a copy (a peer
    copy between cards, a device copy on one card)."""
    return x.to(device, non_blocking=True, copy=True)


def _fold(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """``op`` folded over the shards' partials in shard order, on the first
    shard's device (d = 1: the partial itself)."""
    home = parts[0].device
    out = parts[0]
    for x in parts[1:]:
        out = op(out, replica(x, home))
    return out


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' partials, added in shard order."""
    return _fold(parts, torch.add)


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Maximum of the shards' partials."""
    return _fold(parts, torch.maximum)


def pall(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Logical and of the shards' boolean partials."""
    return _fold(parts, torch.logical_and)


def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' pieces joined in shard order on the first shard's
    device, replicated from there (d = 1: the piece itself)."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    return torch.cat([parts[0]] + [send(x, home) for x in parts[1:]])


def ring_shift(bufs: Sequence[torch.Tensor]) -> list:
    """Every shard's buffer moves to shard k - 1 (the reference's
    ``ppermute`` with perm j -> j - 1): shard k receives shard k + 1's."""
    d = len(bufs)
    return [send(bufs[(k + 1) % d], bufs[k].device) for k in range(d)]


def all_to_all(blocks: Sequence[Sequence[torch.Tensor]]) -> list:
    """``blocks[i][j]`` goes from shard i to shard j; shard j receives
    ``[blocks[0][j], ..., blocks[d-1][j]]``, in shard order."""
    d = len(blocks)
    devs = [row[0].device for row in blocks]
    return [
        [blocks[i][j] if i == j else send(blocks[i][j], devs[j]) for i in range(d)]
        for j in range(d)
    ]


# ---------------------------------------------------------------------------
# Row-sharded primitives (the sharded oversize solver's vocabulary)
# ---------------------------------------------------------------------------


def ring_matmul(a_rows: Sequence[torch.Tensor], b_rows: Sequence[torch.Tensor]) -> list:
    """C = A @ B with A, B, C row-sharded.

    The 1-D ring, in the reference's order: at step k shard i multiplies
    its column slab A[:, rows of shard s], s = (i + k) mod d, by the B
    shard in its ring buffer and adds the product to its running sum,
    then the buffers shift one shard along the ring.  d steps of
    (rl, rl) @ (rl, bp) products a shard; the one extra buffer a shard
    holds is one B shard, never the full (bp, bp) matrix.  d = 1: the
    local product."""
    d = len(a_rows)
    if d == 1:
        return [a_rows[0] @ b_rows[0]]
    rl = a_rows[0].shape[0]
    slabs = [a.split(rl, dim=1) for a in a_rows]  # slabs[i][s] = A_i[:, rows of shard s]
    buf = list(b_rows)
    acc: list = [None] * d
    for k in range(d):
        for i in range(d):
            prod = slabs[i][(i + k) % d] @ buf[i]
            acc[i] = prod if k == 0 else acc[i] + prod
        if k + 1 < d:
            buf = ring_shift(buf)
    return acc


def transpose_rowsharded(a_rows: Sequence[torch.Tensor]) -> list:
    """A^T row-sharded from A row-sharded, by one all-to-all: shard j
    receives every shard's column block j, i.e. the column slab
    A[:, rows of shard j], whose transpose is the rows of A^T it owns.
    d = 1: the local transpose (a view)."""
    if len(a_rows) == 1:
        return [a_rows[0].mT]
    rl = a_rows[0].shape[0]
    received = all_to_all([a.split(rl, dim=1) for a in a_rows])
    return [torch.cat(col).mT for col in received]


def matvec_rowsharded(a_rows: Sequence[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
    """A @ v, replicated, from A row-sharded and v replicated: each shard's
    rows times v, all-gathered (d = 1: the local product)."""
    return all_gather([a @ replica(v, a.device) for a in a_rows])


def eye_rows(row0: int, rows: int, n: int, *, dtype, device) -> torch.Tensor:
    """Rows row0 .. row0 + rows - 1 of the (n, n) identity, formed as that
    (rows, n) slab alone."""
    r = row0 + torch.arange(rows, device=device)
    return (r[:, None] == torch.arange(n, device=device)[None, :]).to(dtype)


def split_rows(x, mesh) -> list:
    """``x`` (numpy or tensor: a square S, or a (n, b, b) block stack) split
    along its first axis into d equal parts, part k placed straight on
    ``mesh[k]`` (no device ever holds the whole of x); the first axis must
    be a multiple of d."""
    mesh = as_mesh(mesh)
    d = len(mesh)
    n = x.shape[0]
    if n % d:
        raise ValueError(f"split_rows: {n} rows do not split over {d} shards")
    m = n // d
    out = []
    for k, dev in enumerate(mesh):
        part = x[k * m : (k + 1) * m]
        t = part if isinstance(part, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(part))
        out.append(t.to(dev))
    return out


#: the reference's name, for a block stack split over the shards
put_sharded_blocks = split_rows


def padded_row_shards(S, mesh) -> list:
    """A square S (numpy or tensor) padded to a multiple of d with isolated
    vertices (zero rows and columns) and split into its d row shards."""
    mesh = as_mesh(mesh)
    pad = (-S.shape[0]) % len(mesh)
    if pad:
        if isinstance(S, torch.Tensor):
            S = torch.nn.functional.pad(S, (0, pad, 0, pad))
        else:
            S = np.pad(np.asarray(S), ((0, pad), (0, pad)))
    return split_rows(S, mesh)


# ---------------------------------------------------------------------------
# The two stages
# ---------------------------------------------------------------------------


def components_of_row_shards(
    S_rows: Sequence[torch.Tensor], lam: float, max_rounds: int | None = None
) -> torch.Tensor:
    """``distributed_components`` on the d row shards of an already padded
    (pp, pp) S; returns all pp int32 labels on the first shard's device."""
    from repro_torch.core.components import propagate_labels
    from repro_torch.kernels.threshold_cc.ops import labelprop_rows

    rows = S_rows[0].shape[0]

    def hook(labels: torch.Tensor) -> torch.Tensor:
        return all_gather([
            labelprop_rows(s, replica(labels, s.device), lam, k * rows)
            for k, s in enumerate(S_rows)
        ])

    labels, rounds = propagate_labels(
        hook, S_rows[0].shape[1], device=S_rows[0].device, max_rounds=max_rounds
    )
    bump("screen.labelprop_rounds", rounds)
    return labels


def distributed_components(
    S, lam: float, mesh, *, max_rounds: int | None = None
) -> torch.Tensor:
    """Row-sharded min-label propagation; returns the (p,) int32 labels
    (canonical at the fixed point) on the mesh's first device.

    p is padded to a multiple of d with isolated vertices (zero rows and
    columns: their labels stay their own indices >= p and are sliced off).
    Each round every shard takes the masked min over its own rows (one
    ``threshold_cc`` row-slab launch on a CUDA shard, the plain version on
    a CPU shard, the diagonal masked by global row), the labels are
    all-gathered and pointer-jumped twice, to a fixed point within pp + 2
    rounds (``max_rounds`` caps them).  Bumps ``screen.labelprop_rounds``
    by the rounds run."""
    return components_of_row_shards(padded_row_shards(S, mesh), lam, max_rounds)[: S.shape[0]]


def count_edges_rowsharded(S_rows: Sequence[torch.Tensor], lam: float) -> int:
    """Strict upper-triangle edges |S_ij| > lam of a row-sharded S, each
    shard's counted on its own device."""
    rows, pp = S_rows[0].shape
    total = 0
    for k, s in enumerate(S_rows):
        cols = torch.arange(pp, device=s.device)
        r = k * rows + torch.arange(rows, device=s.device)
        total += int(((s.abs() > lam) & (cols[None, :] > r[:, None])).sum())
    return total


def _stack_solver(solver) -> Callable:
    """A registered solver's name or a batched stack solver
    ``fn(blocks (N, b, b), lams (N,), **opts)`` as the callable."""
    if isinstance(solver, str):
        from repro_torch.core.solvers import solver_spec

        return solver_spec(solver).fn
    return solver


def distributed_bucket_solve(blocks, lam: float, solver, mesh, **solver_opts) -> torch.Tensor:
    """Split a (n, b, b) stack of padded same-size blocks across the mesh
    and solve each shard's sub-stack on its device with ``solver`` (a
    registered solver's name, or a batched stack solver).  No collectives:
    independence is exactly what Theorem 1 bought us.

    n is padded up to a multiple of d with identity blocks (whose solution
    is I / (1 + lam)); the first n results return, joined on the mesh's
    first device."""
    mesh = as_mesh(mesh)
    fn = _stack_solver(solver)
    blocks = blocks if isinstance(blocks, torch.Tensor) else torch.as_tensor(np.asarray(blocks))
    n, b, _ = blocks.shape
    pad = (-n) % len(mesh)
    if pad:
        eye = torch.eye(b, dtype=blocks.dtype, device=blocks.device)
        blocks = torch.cat([blocks, eye.expand(pad, b, b)])
    outs = [
        fn(s, torch.full((s.shape[0],), float(lam), dtype=s.dtype, device=s.device),
           **solver_opts)
        for s in put_sharded_blocks(blocks, mesh)
    ]
    return all_gather(outs)[:n]


def device_memory_budget_mb(device) -> float | None:
    """The most device memory in MB that the caching allocator may hold on
    ``device``, or None on the CPU, which reports none: the planner's
    ``oversize_budget_mb="auto"`` hook (the engine takes the least over its
    mesh's devices).

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
