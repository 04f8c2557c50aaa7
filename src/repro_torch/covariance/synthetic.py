"""Synthetic problem generators of the paper's experiments (numpy).

Copies of the reference package's generators, bit for bit on the same seed,
so the port's own scripts need nothing of ``repro``:

``paper_synthetic``      Section 4.1: block-of-ones signal + calibrated
                         sigma*UU' noise, so that thresholding at an interval
                         of lambdas recovers exactly K components.
``lambda_interval_for_k`` that interval, from the exact merge profile.
``structured_synthetic`` planted-support covariance whose thresholded
                         components are trees / (mostly) chordal-seeded
                         blocks / chordless cycles, with edge magnitudes
                         spread across a lambda interval; with
                         ``classes=`` a (classes, p, p) stack for the joint
                         K-class workload.
``microarray_like``      latent-factor expression matrix X (n, p) with a
                         power-law module-size structure: the large-scale
                         pipeline's data.
"""

from __future__ import annotations

import numpy as np


def paper_synthetic(K: int, p1: int, *, seed: int = 0) -> np.ndarray:
    """Build S = blkdiag(1, ..., 1) + sigma * U U'  (paper Section 4.1).

    Each of the K signal blocks is the p1 x p1 all-ones matrix.  U has i.i.d.
    standard Gaussian entries and sigma is calibrated so that 1.25x the largest
    absolute off-block-diagonal entry of sigma*UU' equals the smallest nonzero
    entry of the signal (= 1).

    Returns the p x p matrix S with p = K * p1 (float64).
    """
    rng = np.random.default_rng(seed)
    p = K * p1
    S_tilde = np.zeros((p, p))
    for b in range(K):
        sl = slice(b * p1, (b + 1) * p1)
        S_tilde[sl, sl] = 1.0
    U = rng.standard_normal((p, p))
    noise = U @ U.T
    block_id = np.repeat(np.arange(K), p1)
    off_block = block_id[:, None] != block_id[None, :]
    max_off = np.abs(noise[off_block]).max()
    sigma = 1.0 / (1.25 * max_off)
    return S_tilde + sigma * noise


def lambda_interval_for_k(S: np.ndarray, K: int) -> tuple[float, float]:
    """[lambda_min, lambda_max] such that thresholding S at any lambda inside
    gives exactly K connected components (paper Section 4.1 defines
    lambda_I = midpoint, lambda_II = lambda_max of this interval).

    Uses the exact edge-sorted merge profile: components change only at the
    distinct values of |S_ij| (paper Section 4.2).
    """
    from repro_torch.core.partition import merge_profile

    prof = merge_profile(S)
    # prof rows: (edge_value v, n_components, max_comp_size) valid for
    # lambda in [next smaller v, v).
    vals = prof["value"]
    ncomp = prof["n_components"]
    hit = np.nonzero(ncomp == K)[0]
    if hit.size == 0:
        raise ValueError(f"no lambda gives exactly {K} components")
    lo_idx, hi_idx = hit[0], hit[-1]
    # Row k's component structure holds for lambda in [v_{k+1}, v_k) — open at
    # the top because eq. (4) thresholds *strictly*.  The returned closed
    # interval therefore tops out just below v_{lo}.
    lam_max = float(np.nextafter(vals[lo_idx], 0.0))
    lam_min = float(vals[hi_idx + 1]) if hi_idx + 1 < vals.size else 0.0
    return lam_min, lam_max


def _planted_edges(rng, kind: str, p1: int) -> list[tuple[int, int]]:
    """Within-block support of one planted component: tree / 2-tree / cycle."""
    if kind == "tree":
        return [(i, int(rng.integers(0, i))) for i in range(1, p1)]
    if kind == "chordal":
        edges = [(1, 0), (2, 0), (2, 1)]
        for v in range(3, p1):
            a = int(rng.integers(0, v))
            b = int(rng.integers(0, v))
            while b == a:
                b = int(rng.integers(0, v))
            edges += [(v, a), (v, b)]
        return edges
    return [(i, (i + 1) % p1) for i in range(p1)]  # chordless cycle


def structured_synthetic(
    K: int,
    p1: int,
    *,
    tree_frac: float = 0.6,
    chordal_frac: float = 0.25,
    lam_lo: float = 0.3,
    lam_hi: float = 0.8,
    noise: float = 0.9,
    seed: int = 0,
    classes: int | None = None,
    shared_fraction: float = 1.0,
) -> np.ndarray:
    """Covariance with K planted p1-vertex components of known structure.

    Component i's within-block support is a random recursive tree (first
    ``tree_frac`` of blocks), a triangle grown by joining each further
    vertex to two random earlier vertices (next ``chordal_frac``; chordal
    only when those two are adjacent, so most such blocks classify
    "general"), or a chordless cycle (the rest).  Edge magnitudes are uniform in
    [lam_lo, lam_hi] and off-block noise stays below ``noise * lam_lo``, so
    any lambda in (noise * lam_lo, lam_hi) screens into (pieces of) the
    planted blocks; descending through the interval both densifies each
    block's subgraph and merges pieces — the full structure-classification
    story on one path.  Diagonals are set diagonally dominant, keeping the
    soft-thresholded matrix PD (the closed-form regime of the ladder bench).

    Returns the p x p matrix S with p = K * p1 (float64), columns shuffled.

    Multi-class (``classes=k``): a (classes, p, p) stack for the joint
    workload (``repro_torch.joint``).  The first ``round(shared_fraction *
    K)`` planted blocks are identical across classes (the joint routing
    ladder's closed-form regime); the rest are re-drawn per class (the
    joint ADMM regime).  Off-block noise is drawn per class, below
    ``noise * lam_lo``; diagonals use the class-max absolute row sum, so
    shared blocks stay bit-identical and every class diagonally dominant;
    one column permutation serves all classes."""
    if classes is not None:
        return _structured_synthetic_classes(
            K, p1, int(classes), shared_fraction,
            tree_frac=tree_frac, chordal_frac=chordal_frac,
            lam_lo=lam_lo, lam_hi=lam_hi, noise=noise, seed=seed,
        )
    rng = np.random.default_rng(seed)
    p = K * p1
    S = np.zeros((p, p))
    n_tree = int(round(tree_frac * K))
    n_chordal = int(round(chordal_frac * K))
    for blk in range(K):
        base = blk * p1
        if blk < n_tree:
            edges = [(i, int(rng.integers(0, i))) for i in range(1, p1)]
        elif blk < n_tree + n_chordal:
            # triangle seed, then each vertex joins two random earlier vertices
            edges = [(1, 0), (2, 0), (2, 1)]
            for v in range(3, p1):
                a = int(rng.integers(0, v))
                b = int(rng.integers(0, v))
                while b == a:
                    b = int(rng.integers(0, v))
                edges += [(v, a), (v, b)]
        else:
            edges = [(i, (i + 1) % p1) for i in range(p1)]  # chordless cycle
        for i, j in edges:
            v = rng.uniform(lam_lo, lam_hi) * (1 if rng.random() < 0.5 else -1)
            S[base + i, base + j] = S[base + j, base + i] = v
    # off-block noise strictly below the screening range
    mask = S == 0
    np.fill_diagonal(mask, False)
    tri = np.triu(mask, 1)
    vals = rng.uniform(0, noise * lam_lo, size=int(tri.sum()))
    signs = rng.choice([-1.0, 1.0], size=vals.size)
    S[tri] = vals * signs
    S = np.triu(S, 1)
    S = S + S.T
    np.fill_diagonal(S, 1.0 + np.abs(S).sum(axis=1))
    perm = rng.permutation(p)
    return S[np.ix_(perm, perm)]


def _structured_synthetic_classes(
    K: int,
    p1: int,
    n_classes: int,
    shared_fraction: float,
    *,
    tree_frac: float,
    chordal_frac: float,
    lam_lo: float,
    lam_hi: float,
    noise: float,
    seed: int,
) -> np.ndarray:
    """The multi-class branch of ``structured_synthetic`` (its own RNG
    stream, the reference's draw for draw)."""
    rng = np.random.default_rng(seed)
    p = K * p1
    n_tree = int(round(tree_frac * K))
    n_chordal = int(round(chordal_frac * K))
    n_shared = int(round(np.clip(shared_fraction, 0.0, 1.0) * K))
    kinds = [
        "tree" if b < n_tree else
        "chordal" if b < n_tree + n_chordal else "cycle"
        for b in range(K)
    ]
    stacks = np.zeros((n_classes, p, p))

    def fill(S, base, edges, gen):
        for i, j in edges:
            v = gen.uniform(lam_lo, lam_hi) * (1 if gen.random() < 0.5 else -1)
            S[base + i, base + j] = S[base + j, base + i] = v

    for blk in range(K):
        base = blk * p1
        if blk < n_shared:
            edges = _planted_edges(rng, kinds[blk], p1)
            vals = [
                (i, j,
                 rng.uniform(lam_lo, lam_hi) * (1 if rng.random() < 0.5 else -1))
                for i, j in edges
            ]
            for k in range(n_classes):
                for i, j, v in vals:
                    stacks[k, base + i, base + j] = v
                    stacks[k, base + j, base + i] = v
        else:
            for k in range(n_classes):
                fill(stacks[k], base, _planted_edges(rng, kinds[blk], p1), rng)
    # off-block noise, strictly below the screening range, per class
    block_id = np.repeat(np.arange(K), p1)
    off_block = np.triu(block_id[:, None] != block_id[None, :], 1)
    n_off = int(off_block.sum())
    for k in range(n_classes):
        vals = rng.uniform(0, noise * lam_lo, size=n_off)
        signs = rng.choice([-1.0, 1.0], size=n_off)
        stacks[k][off_block] = vals * signs
        stacks[k] = np.triu(stacks[k], 1)
        stacks[k] = stacks[k] + stacks[k].T
    # class-max row sums keep shared blocks identical and every class
    # diagonally dominant
    diag = 1.0 + np.abs(stacks).sum(axis=2).max(axis=0)
    for k in range(n_classes):
        np.fill_diagonal(stacks[k], diag)
    perm = rng.permutation(p)
    return stacks[:, perm][:, :, perm]


def microarray_like(
    n: int,
    p: int,
    *,
    n_modules: int = 40,
    min_module: int = 4,
    alpha: float = 1.6,
    noise: float = 0.6,
    seed: int = 0,
) -> np.ndarray:
    """Latent-factor expression matrix X (n x p) whose correlation matrix has a
    power-law module-size structure.

    Genes are partitioned into modules with sizes ~ Zipf(alpha) (clipped), each
    module driven by one latent factor with per-gene loading in [0.4, 1]; the
    remaining genes are pure noise (isolated at moderate lambda).  This
    reproduces the qualitative Figure-1 behaviour: decreasing lambda merges
    modules into growing components while isolated nodes dominate at large
    lambda.
    """
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.zipf(alpha, size=n_modules), min_module, max(p // 8, min_module))
    # Keep total module genes <= 70% of p; the rest are background noise genes.
    budget = int(0.7 * p)
    keep, tot = [], 0
    for s in sizes:
        if tot + int(s) > budget:
            break
        keep.append(int(s))
        tot += int(s)
    X = rng.standard_normal((n, p)) * noise
    g = 0
    for s in keep:
        z = rng.standard_normal((n, 1))
        load = rng.uniform(0.4, 1.0, size=(1, s)) * rng.choice([-1.0, 1.0], size=(1, s))
        X[:, g : g + s] += z @ load
        g += s
    # Shuffle columns so component structure is not contiguous (exercises the
    # permutation story in Theorem 1).
    perm = rng.permutation(p)
    return X[:, perm]
