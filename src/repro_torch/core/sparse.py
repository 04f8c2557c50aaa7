"""Sparse-native result representation: Theta without the (p, p) wall.

Theorem 1 makes the glasso solution block-diagonal over the screened
components, so everything the solve produces is already sparse: per-bucket
padded solution stacks plus a closed-form diagonal for isolated vertices.
``SparseTheta`` keeps exactly that — the executor's padded solution stacks
as they came back from the device (numpy arrays, not copied again), a (p,)
component index map, and the isolated values — and serves global views
(COO/CSR/dense) only on demand.  Peak result memory is O(nnz + sum b_i^2)
instead of O(p^2).  The public types are numpy arrays, as in the reference
package (``repro.core.sparse``), whose layout this module keeps:

    _stacks            list of (n_i, size_i, size_i) padded solution stacks,
                       one per plan bucket — the executor's own host arrays
    _comps / _loc      flat component list + (stack, row) locator per comp
    _comp_id           (p,) vertex -> flat component index, -1 if isolated
    _pos_in            (p,) vertex -> row within its block (or its position
                       in ``isolated`` when isolated)
    isolated(_values)  vertex ids with |comp| = 1 and their closed-form
                       Theta_ii = 1/(S_ii + lam)

``gather_block`` differs from the covariance materializer's on purpose: a
result IS defined across components (exact zeros there, by Theorem 1), so
cross-component gathers return the block-diagonal restriction instead of
raising.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "AUTO_SPARSE_P",
    "DENSIFY_MAX_P",
    "SparseTheta",
    "JointSparseTheta",
    "resolve_output",
    "result_nbytes",
]

#: ``output="auto"`` returns a SparseTheta above this p (and a dense array
#: at or below it).  8192^2 float64 = 512 MB — the last size where a dense
#: result is still a reasonable default.
AUTO_SPARSE_P = 8192

#: ``toarray()`` refuses above this p unless forced — densifying a result
#: the pipeline went out of its way never to allocate should be loud.
DENSIFY_MAX_P = 8192


def resolve_output(output, p: int) -> str:
    """Normalize an ``output=`` argument to "dense" or "sparse".

    None and "auto" pick by problem size (> ``AUTO_SPARSE_P`` -> sparse)."""
    if output is None:
        output = "auto"
    if output == "auto":
        return "sparse" if int(p) > AUTO_SPARSE_P else "dense"
    if output not in ("dense", "sparse"):
        raise ValueError(f"output must be 'dense', 'sparse' or 'auto', got {output!r}")
    return output


def result_nbytes(Theta) -> int:
    """Resident bytes of a result Theta — ndarray ``.nbytes`` attribute or a
    sparse result's ``.nbytes()`` method, whichever the object carries."""
    nb = Theta.nbytes
    return int(nb() if callable(nb) else nb)


def _build_index(p: int, comps: list[np.ndarray], isolated: np.ndarray):
    """(p,) vertex -> flat component id (-1 if isolated) and row-within-block
    (position within ``isolated`` for isolated vertices)."""
    comp_id = np.full(p, -1, dtype=np.int64)
    pos_in = np.zeros(p, dtype=np.int64)
    for j, c in enumerate(comps):
        comp_id[c] = j
        pos_in[c] = np.arange(c.size)
    if isolated.size:
        pos_in[isolated] = np.arange(isolated.size)
    return comp_id, pos_in


class SparseTheta:
    """Block-sparse precision matrix: padded stacks + component index map.

    Construct via ``core.blocks.assemble_sparse`` (single-class) — not by
    hand.  Behaves like a matrix where it matters (``shape``, ``diagonal``,
    ``gather_block``/``diag_at``) and converts on demand (``to_coo``,
    ``to_csr``, ``toarray``); ``np.asarray`` on an oversize result raises
    rather than reintroducing the O(p^2) allocation."""

    def __init__(
        self, p: int, dtype, stacks: list[np.ndarray], comps: list[np.ndarray],
        loc: list[tuple[int, int]], comp_id: np.ndarray, pos_in: np.ndarray,
        isolated: np.ndarray, isolated_values: np.ndarray,
        *, densify_max: int = DENSIFY_MAX_P,
    ):
        self.p = int(p)
        self.dtype = np.dtype(dtype)
        self._stacks = stacks
        self._comps = comps
        self._loc = loc
        self._comp_id = comp_id
        self._pos_in = pos_in
        self.isolated = isolated
        self.isolated_values = isolated_values
        self.densify_max = int(densify_max)

    # -- matrix-like surface ----------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return (self.p, self.p)

    @property
    def n_components(self) -> int:
        return len(self._comps) + int(self.isolated.size)

    def component_block(self, j: int) -> np.ndarray:
        """The (b, b) solution block of flat component ``j`` — a VIEW into
        the padded stack, no copy."""
        s, r = self._loc[j]
        b = self._comps[j].size
        return self._stacks[s][r, :b, :b]

    def blocks(self):
        """Yield (vertex array, (b, b) block view) per non-singleton
        component."""
        for j, c in enumerate(self._comps):
            yield c, self.component_block(j)

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.p, dtype=self.dtype)
        if self.isolated.size:
            d[self.isolated] = self.isolated_values
        for c, blk in self.blocks():
            d[c] = np.diagonal(blk)
        return d

    @property
    def nnz(self) -> int:
        """Stored nonzeros (isolated diagonal + block entries != 0) —
        matches ``np.count_nonzero`` of the densified matrix exactly."""
        n = int(np.count_nonzero(self.isolated_values))
        for _, blk in self.blocks():
            n += int(np.count_nonzero(blk))
        return n

    def logdet(self) -> float:
        """log det(Theta), summed per component (Theorem 1: the matrix is
        block-diagonal over them, so the determinant factors) — per-block
        ``slogdet`` plus the isolated log(theta_ii) terms, never a global
        dense factorization.  -inf when any block is not PD (a result from
        the solvers never is)."""
        total = 0.0
        if self.isolated.size:
            vals = np.asarray(self.isolated_values, dtype=np.float64)
            if np.any(vals <= 0):
                return float("-inf")
            total += float(np.sum(np.log(vals)))
        for _, blk in self.blocks():
            sign, val = np.linalg.slogdet(np.asarray(blk))
            if sign <= 0:
                return float("-inf")
            total += float(val)
        return total

    def nbytes(self) -> int:
        """Resident bytes: padded stacks + index maps + isolated values.
        The stacks are shared with the executor's output, so this is the
        result's whole footprint, not an increment over it."""
        return int(
            sum(s.nbytes for s in self._stacks)
            + self._comp_id.nbytes + self._pos_in.nbytes
            + self.isolated.nbytes + self.isolated_values.nbytes
        )

    # -- gather protocol (result side) -------------------------------------

    def gather_block(self, idx: np.ndarray) -> np.ndarray:
        """Theta[np.ix_(idx, idx)] as a dense (|idx|, |idx|) array.

        Unlike the covariance materializer, CROSS-component index sets are
        fine: entries between distinct components are exact zeros (Theorem
        1), so the gather returns the block-diagonal restriction — the warm
        start's merged-component W is built through exactly this."""
        idx = np.asarray(idx)
        out = np.zeros((idx.size, idx.size), dtype=self.dtype)
        cid = self._comp_id[idx]
        iso = np.where(cid < 0)[0]
        if iso.size:
            out[iso, iso] = self.isolated_values[self._pos_in[idx[iso]]]
        for j in np.unique(cid[cid >= 0]):
            sel = np.where(cid == j)[0]
            pos = self._pos_in[idx[sel]]
            out[np.ix_(sel, sel)] = self.component_block(int(j))[np.ix_(pos, pos)]
        return out

    def diag_at(self, idx) -> np.ndarray:
        return self.diagonal()[idx]

    # -- global views -------------------------------------------------------

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, values) of every stored nonzero — identical entry
        set to ``np.nonzero`` of the densified matrix."""
        rows, cols, vals = [], [], []
        nz = np.nonzero(self.isolated_values)[0]
        if nz.size:
            rows.append(self.isolated[nz])
            cols.append(self.isolated[nz])
            vals.append(self.isolated_values[nz])
        for c, blk in self.blocks():
            ri, ci = np.nonzero(blk)
            rows.append(c[ri])
            cols.append(c[ci])
            vals.append(blk[ri, ci])
        if not rows:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=self.dtype)
        return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)

    def to_csr(self):
        """scipy.sparse CSR view of the full matrix (built on demand)."""
        from scipy import sparse as sp

        r, c, v = self.to_coo()
        return sp.coo_matrix((v, (r, c)), shape=self.shape, dtype=self.dtype).tocsr()

    def toarray(self, *, force: bool = False) -> np.ndarray:
        """Densify.  Refuses above ``densify_max`` unless ``force=True`` —
        the caller is about to allocate the very buffer the sparse path
        exists to avoid, and should have to say so."""
        if self.p > self.densify_max and not force:
            raise ValueError(
                f"refusing to densify a ({self.p}, {self.p}) sparse result "
                f"(> densify_max={self.densify_max}); use toarray(force=True), "
                "to_csr(), or blocks()"
            )
        out = np.zeros((self.p, self.p), dtype=self.dtype)
        if self.isolated.size:
            out[self.isolated, self.isolated] = self.isolated_values
        for c, blk in self.blocks():
            out[np.ix_(c, c)] = blk
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.toarray()
        return arr if dtype is None else arr.astype(dtype, copy=False)

    # -- support ------------------------------------------------------------

    def support_edges(self) -> np.ndarray:
        """(E, 2) array of off-diagonal upper-triangular support edges —
        the edge-list form serving payloads carry at any p."""
        edges = []
        for c, blk in self.blocks():
            ri, ci = np.nonzero(blk)
            keep = ri < ci
            if keep.any():
                edges.append(np.stack([c[ri[keep]], c[ci[keep]]], axis=1))
        if not edges:
            return np.zeros((0, 2), dtype=np.int64)
        e = np.concatenate(edges).astype(np.int64)
        return e[np.lexsort((e[:, 1], e[:, 0]))]

    def support(self):
        """Adjacency of the estimated concentration graph: dense bool up to
        ``densify_max``, scipy bool CSR above it."""
        if self.p <= self.densify_max:
            A = np.zeros((self.p, self.p), dtype=bool)
            e = self.support_edges()
            A[e[:, 0], e[:, 1]] = True
            A[e[:, 1], e[:, 0]] = True
            return A
        from scipy import sparse as sp

        e = self.support_edges()
        data = np.ones(2 * len(e), dtype=bool)
        r = np.concatenate([e[:, 0], e[:, 1]])
        c = np.concatenate([e[:, 1], e[:, 0]])
        return sp.coo_matrix((data, (r, c)), shape=self.shape, dtype=bool).tocsr()

    def __repr__(self) -> str:
        return (
            f"SparseTheta(p={self.p}, components={self.n_components}, "
            f"nnz={self.nnz}, dtype={self.dtype.name})"
        )


class JointSparseTheta:
    """K-class block-sparse result: (n_i, K, size_i, size_i) stacks sharing
    one component index across classes (the union-graph partition).

    ``shape`` is (K, p, p) and ``result[k]`` is a zero-copy single-class
    ``SparseTheta`` over per-class stack views, so everything downstream of
    a single-class result (KKT, support, COO dumps) reuses unchanged."""

    def __init__(
        self, K: int, p: int, dtype, stacks: list[np.ndarray],
        comps: list[np.ndarray], loc: list[tuple[int, int]],
        comp_id: np.ndarray, pos_in: np.ndarray,
        isolated: np.ndarray, isolated_values: np.ndarray,
        *, densify_max: int = DENSIFY_MAX_P,
    ):
        self.K = int(K)
        self.p = int(p)
        self.dtype = np.dtype(dtype)
        self._stacks = stacks              # per bucket: (n, K, size, size)
        self._comps = comps
        self._loc = loc
        self._comp_id = comp_id
        self._pos_in = pos_in
        self.isolated = isolated
        self.isolated_values = isolated_values   # (K, n_isolated)
        self.densify_max = int(densify_max)
        self._views: dict[int, SparseTheta] = {}

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.K, self.p, self.p)

    @property
    def n_components(self) -> int:
        return len(self._comps) + int(self.isolated.size)

    def class_view(self, k: int) -> SparseTheta:
        k = int(k)
        if not 0 <= k < self.K:
            raise IndexError(f"class index {k} out of range for K={self.K}")
        if k not in self._views:
            self._views[k] = SparseTheta(
                self.p, self.dtype, [s[:, k] for s in self._stacks],
                self._comps, self._loc, self._comp_id, self._pos_in,
                self.isolated, self.isolated_values[k],
                densify_max=self.densify_max,
            )
        return self._views[k]

    def __getitem__(self, k: int) -> SparseTheta:
        return self.class_view(k)

    def blocks(self):
        """Yield (vertex array, (K, b, b) block view) per union component."""
        for j, c in enumerate(self._comps):
            s, r = self._loc[j]
            yield c, self._stacks[s][r, :, : c.size, : c.size]

    @property
    def nnz(self) -> int:
        return sum(self.class_view(k).nnz for k in range(self.K))

    def nbytes(self) -> int:
        return int(
            sum(s.nbytes for s in self._stacks)
            + self._comp_id.nbytes + self._pos_in.nbytes
            + self.isolated.nbytes + self.isolated_values.nbytes
        )

    def toarray(self, *, force: bool = False) -> np.ndarray:
        if self.p > self.densify_max and not force:
            raise ValueError(
                f"refusing to densify a ({self.K}, {self.p}, {self.p}) sparse "
                f"result (> densify_max={self.densify_max}); use "
                "toarray(force=True) or class_view(k)"
            )
        return np.stack(
            [self.class_view(k).toarray(force=force) for k in range(self.K)]
        )

    def __array__(self, dtype=None, copy=None):
        arr = self.toarray()
        return arr if dtype is None else arr.astype(dtype, copy=False)

    def support_edges(self) -> np.ndarray:
        """Union support edges: an (i, j) pair present in ANY class."""
        es = [self.class_view(k).support_edges() for k in range(self.K)]
        e = np.unique(np.concatenate(es), axis=0)
        return e[np.lexsort((e[:, 1], e[:, 0]))] if len(e) else e

    def support(self):
        """Union concentration-graph adjacency across classes (dense bool up
        to ``densify_max``, scipy bool CSR above)."""
        if self.p <= self.densify_max:
            A = np.zeros((self.p, self.p), dtype=bool)
            e = self.support_edges()
            if len(e):
                A[e[:, 0], e[:, 1]] = True
                A[e[:, 1], e[:, 0]] = True
            return A
        from scipy import sparse as sp

        e = self.support_edges()
        data = np.ones(2 * len(e), dtype=bool)
        r = np.concatenate([e[:, 0], e[:, 1]])
        c = np.concatenate([e[:, 1], e[:, 0]])
        return sp.coo_matrix((data, (r, c)), shape=(self.p, self.p), dtype=bool).tocsr()

    def __repr__(self) -> str:
        return (
            f"JointSparseTheta(K={self.K}, p={self.p}, "
            f"components={self.n_components}, dtype={self.dtype.name})"
        )
