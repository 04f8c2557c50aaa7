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

Memory: the sum of the materialized block sizes squared (what the solve
stage holds anyway) plus one (n, |C|) centered gather per component.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.instrument import set_peak


class MaterializedCovariance:
    """Per-component covariance blocks + diagonal, standing in for S.

    Supports exactly the access patterns the Plan->Execute pipeline uses:
    ``shape``, ``gather_block(idx)`` for same-component index sets (bucket
    padding, structure classification), ``gather_block_rows(rows, cols)``
    and ``diag_at(idx)`` (isolated-vertex assembly).  Cross-component
    entries do not exist — by Theorem 1 they are never needed; asking for
    them is a bug and raises."""

    def __init__(
        self, p: int, diag: np.ndarray, blocks: dict[int, np.ndarray],
        root_of: np.ndarray, pos_in: np.ndarray,
    ):
        self.p = int(p)
        self._diag = diag
        self._blocks = blocks          # component root -> (b, b) block
        self._root_of = root_of        # vertex -> component root
        self._pos_in = pos_in          # vertex -> row within its block
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

    def gather_block(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        return self.gather_block_rows(idx, idx)

    def gather_block_rows(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        root = self._common_root(np.concatenate([rows, cols]))
        blk = self._blocks.get(root)
        if blk is None:  # an isolated vertex: the diagonal only
            out = np.zeros((rows.size, cols.size), dtype=self.dtype)
            ri, ci = np.nonzero(rows[:, None] == cols[None, :])
            out[ri, ci] = self._diag[rows[ri]]
            return out
        return blk[np.ix_(self._pos_in[rows], self._pos_in[cols])]

    def diag_at(self, idx) -> np.ndarray:
        return self._diag[idx]

    def nbytes(self) -> int:
        return (
            self._diag.nbytes
            + self._root_of.nbytes
            + self._pos_in.nbytes
            + sum(b.nbytes for b in self._blocks.values())
        )


def materialize_components(
    X: torch.Tensor,
    mu: torch.Tensor,
    diag: np.ndarray,
    labels: np.ndarray,
) -> MaterializedCovariance:
    """Gather S[C, C] for every non-singleton component of ``labels``.

    X: (n, p) on the device the blocks are computed on, mu: (p,) its column
    means.  Blocks are float64, as in the reference:
    (X[:, C] - mu[C])'(X[:, C] - mu[C]) / n, symmetrized —
    ``sample_covariance``'s arithmetic restricted to C, so on exactly
    representable float64 data they equal the dense estimator's blocks bit
    for bit.  Block diagonals are overwritten with the moments pass's
    ``diag`` so isolated-vertex assembly and block solves see one S_ii."""
    from repro_torch.core.components import component_lists

    n, p = X.shape
    root_of = np.asarray(labels, dtype=np.int64)
    pos_in = np.zeros(p, dtype=np.int64)
    X = X.to(torch.float64)
    mu = mu.to(device=X.device, dtype=torch.float64)
    diag = np.asarray(diag, dtype=np.float64)
    comps = []
    parts = []
    for comp in component_lists(labels):
        pos_in[comp] = np.arange(comp.size)
        if comp.size == 1:
            continue
        idx = torch.as_tensor(comp, device=X.device)
        Xc = X[:, idx] - mu[idx]
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
    mat = MaterializedCovariance(p, diag, blocks, root_of, pos_in)
    set_peak("stream.bytes_peak", mat.nbytes())
    return mat


def shard_gather(*_args, **_kwargs):
    """The sharded oversize route's loader is not ported yet."""
    raise NotImplementedError(
        "shard_gather (the sharded giant-block route) is not ported yet (slice 9)"
    )
