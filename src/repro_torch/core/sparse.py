"""Result representation: when ``output="auto"`` means sparse.

Only the dense (p, p) result is ported so far; the block-sparse
``SparseTheta`` and its assembly come with the sparse-native slice, and a
solve that resolves to "sparse" raises ``NotImplementedError`` rather than
quietly returning dense."""

from __future__ import annotations

#: ``output="auto"`` returns a SparseTheta above this p (and a dense array
#: at or below it).  8192^2 float64 = 512 MB.
AUTO_SPARSE_P = 8192


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
