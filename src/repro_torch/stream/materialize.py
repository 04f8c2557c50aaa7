"""Component materializer: the only covariance entries the solvers ever see.

Theorem 1 reduces the glasso solve to independent blocks over the screened
components, and Theorem 2 nests every partition of a descending lambda grid
inside the partition at the grid minimum — so the union of all covariance
entries any plan on the grid can request is exactly the per-component
sub-blocks S[C, C] of that COARSEST partition.  ``materialize_components``
computes them from X on X's device, in the arithmetic of
``covariance.sample_covariance`` restricted to C (centered columns, one
matrix product, divide by n, symmetrize), and brings them to the host in
one transfer; ``MaterializedCovariance`` serves them through the gather
protocol (``gather_block`` / ``gather_block_rows`` / ``diag_at``) that
``core.blocks`` and ``engine.structure`` dispatch on — the planner,
executor, classifier and assembler consume materialized blocks unchanged,
never a (p, p) array.

OVERSIZE components (larger than the planner's single-device threshold) are
DEFERRED: no block is built at all — only the component's centered columns
(n, b) are kept on X's device, and ``shard_gather`` later computes the
block from them one row chunk at a time, straight onto the solve's device.
The full (b, b) host copy of a giant component never exists.

Memory: the sum of the materialized block sizes squared (what the solve
stage holds anyway) plus one (n, |C|) centered gather per component.

Counters (repro_torch.core.instrument):
    stream.deferred_components   oversize components kept as columns
    stream.deferred_gathers      gathers served from deferred columns
    stream.shard_chunks          row chunks ``shard_gather`` placed
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.instrument import bump, set_peak


class MaterializedCovariance:
    """Per-component covariance blocks + diagonal, standing in for S.

    Supports exactly the access patterns the Plan->Execute pipeline uses:
    ``shape``, ``gather_block(idx)`` for same-component index sets (bucket
    padding, structure classification), ``gather_block_rows(rows, cols)``
    and ``diag_at(idx)`` (isolated-vertex assembly).  Cross-component
    entries do not exist — by Theorem 1 they are never needed; asking for
    them is a bug and raises.  DEFERRED (oversize) components keep no
    block: their entries are recomputed from the retained centered columns
    on demand, which ``shard_gather`` does row chunk by row chunk."""

    def __init__(
        self, p: int, diag: np.ndarray, blocks: dict[int, np.ndarray],
        root_of: np.ndarray, pos_in: np.ndarray,
        deferred: dict[int, torch.Tensor] | None = None,
    ):
        self.p = int(p)
        self._diag = diag
        self._blocks = blocks          # component root -> (b, b) block
        self._root_of = root_of        # vertex -> component root
        self._pos_in = pos_in          # vertex -> row within its block
        # component root -> centered X[:, comp] columns (n, b), on X's device
        self._deferred = deferred or {}
        self.dtype = diag.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.p, self.p)

    def _common_root(self, idx: np.ndarray) -> int:
        roots = self._root_of[idx]
        root = int(roots[0])
        if not (roots == root).all():
            raise ValueError(
                "gather called across components — Theorem 1 says no stage "
                "should ever need those entries"
            )
        return root

    def _deferred_rows(self, root: int, rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
        """S[rows, cols] of a deferred component as a tensor on the columns'
        device, from its centered columns: one (len(rows), len(cols)) Gram
        chunk, with the moments pass's exact diagonal."""
        bump("stream.deferred_gathers")
        Xc = self._deferred[root]
        dev = Xc.device
        pos_r = torch.as_tensor(self._pos_in[rows], device=dev)
        pos_c = torch.as_tensor(self._pos_in[cols], device=dev)
        out = (Xc[:, pos_r].T @ Xc[:, pos_c]) / Xc.shape[0]
        ri, ci = np.nonzero(rows[:, None] == cols[None, :])
        if ri.size:
            out[torch.as_tensor(ri, device=dev), torch.as_tensor(ci, device=dev)] = (
                torch.as_tensor(self._diag[rows[ri]], device=dev)
            )
        return out

    def gather_block(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        return self.gather_block_rows(idx, idx)

    def gather_block_rows(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        root = self._common_root(np.concatenate([rows, cols]))
        blk = self._blocks.get(root)
        if blk is None and root in self._deferred:
            return self._deferred_rows(root, rows, cols).cpu().numpy().astype(
                self.dtype, copy=False
            )
        if blk is None:  # an isolated vertex: the diagonal only
            out = np.zeros((rows.size, cols.size), dtype=self.dtype)
            ri, ci = np.nonzero(rows[:, None] == cols[None, :])
            out[ri, ci] = self._diag[rows[ri]]
            return out
        return blk[np.ix_(self._pos_in[rows], self._pos_in[cols])]

    def gather_rows_tensor(self, rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
        """``gather_block_rows`` as a tensor: a deferred component's chunk
        stays on its columns' device (no host round trip), any other comes
        from the host blocks."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        root = self._common_root(np.concatenate([rows, cols]))
        if root in self._deferred:
            return self._deferred_rows(root, rows, cols)
        return torch.as_tensor(self.gather_block_rows(rows, cols))

    def diag_at(self, idx) -> np.ndarray:
        return self._diag[idx]

    def nbytes(self) -> int:
        return (
            self._diag.nbytes
            + self._root_of.nbytes
            + self._pos_in.nbytes
            + sum(b.nbytes for b in self._blocks.values())
            + sum(Xc.numel() * Xc.element_size() for Xc in self._deferred.values())
        )


def materialize_components(
    X: torch.Tensor,
    mu: torch.Tensor,
    diag: np.ndarray,
    labels: np.ndarray,
    *,
    oversize: int | None = None,
) -> MaterializedCovariance:
    """Gather S[C, C] for every non-singleton component of ``labels``.

    X: (n, p) on the device the blocks are computed on, mu: (p,) its column
    means.  Blocks are float64, as in the reference:
    (X[:, C] - mu[C])'(X[:, C] - mu[C]) / n, symmetrized —
    ``sample_covariance``'s arithmetic restricted to C, so on exactly
    representable float64 data they equal the dense estimator's blocks bit
    for bit.  Block diagonals are overwritten with the moments pass's
    ``diag`` so isolated-vertex assembly and block solves see one S_ii.

    Components larger than ``oversize`` are DEFERRED: only their centered
    columns (n, b) are kept, on X's device, and the (b, b) block is never
    formed — ``shard_gather`` computes it chunk-wise onto the solve's
    device."""
    from repro_torch.core.components import component_lists

    n, p = X.shape
    root_of = np.asarray(labels, dtype=np.int64)
    pos_in = np.zeros(p, dtype=np.int64)
    X = X.to(torch.float64)
    mu = mu.to(device=X.device, dtype=torch.float64)
    diag = np.asarray(diag, dtype=np.float64)
    comps = []
    parts = []
    deferred: dict[int, torch.Tensor] = {}
    for comp in component_lists(labels):
        pos_in[comp] = np.arange(comp.size)
        if comp.size == 1:
            continue
        idx = torch.as_tensor(comp, device=X.device)
        Xc = X[:, idx] - mu[idx]
        if oversize is not None and comp.size > oversize:
            deferred[int(root_of[comp[0]])] = Xc
            bump("stream.deferred_components")
            continue
        B = (Xc.T @ Xc) / n
        parts.append((0.5 * (B + B.T)).reshape(-1))
        comps.append(comp)
    flat = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, dtype=diag.dtype)
    blocks: dict[int, np.ndarray] = {}
    off = 0
    for comp in comps:
        b = comp.size
        B = flat[off : off + b * b].reshape(b, b)
        off += b * b
        np.fill_diagonal(B, diag[comp])
        blocks[int(root_of[comp[0]])] = B
    mat = MaterializedCovariance(p, diag, blocks, root_of, pos_in, deferred)
    set_peak("stream.bytes_peak", mat.nbytes())
    return mat


#: rows of S[comp, comp] ``shard_gather`` fetches and places at a time
GATHER_ROWS = 1024


def shard_gather(S, comp: np.ndarray, mesh=None, *, dtype=None, device="cuda") -> list:
    """Gather S[comp, comp] STRAIGHT into the row shards of the sharded
    solver's identity-padded (bp, bp) block on ``mesh``
    (``local_device_mesh(device)`` by default): a list of d (bp/d, bp)
    tensors, shard k on ``mesh[k]``.

    The sharded oversize route's loader: each shard is allocated on its
    device as its rows of the identity, and its rows inside the block are
    filled ``GATHER_ROWS`` rows at a time through the gather protocol —
    dense slices, a materialized block's row view, or a deferred
    component's Gram chunk computed on its own device — each chunk going
    straight to the shard's device (``stream.shard_chunks`` counts the
    chunks).  Host peak is one row chunk: the full (b, b) block never
    exists on the host."""
    from repro_torch.core.blocks import gather_submatrix_rows
    from repro_torch.core.distributed import as_mesh, eye_rows, local_device_mesh
    from repro_torch.core.solvers.sharded import sharded_pad_size

    comp = np.asarray(comp)
    b = comp.size
    mesh = local_device_mesh(device) if mesh is None else as_mesh(mesh)
    d = len(mesh)
    bp = sharded_pad_size(b, d)
    rl = bp // d
    np_dtype = np.dtype("float64" if dtype is None else np.dtype(dtype).name)
    t_dtype = getattr(torch, np_dtype.name)
    shards = []
    for k, dev in enumerate(mesh):
        lo, hi = k * rl, (k + 1) * rl
        out = eye_rows(lo, rl, bp, dtype=t_dtype, device=dev)
        for r0 in range(lo, min(hi, b), GATHER_ROWS):
            rows = comp[r0 : min(r0 + GATHER_ROWS, hi, b)]
            if hasattr(S, "gather_rows_tensor"):
                chunk = S.gather_rows_tensor(rows, comp)
            else:
                chunk = torch.as_tensor(gather_submatrix_rows(S, rows, comp, dtype=np_dtype))
            out[r0 - lo : r0 - lo + rows.size, :b] = chunk.to(device=dev, dtype=t_dtype)
            bump("stream.shard_chunks")
        shards.append(out)
    return shards
