"""Trees of tensors as the reference's pytrees: nested dicts (keys in
sorted order, as ``jax.tree`` flattens them), lists and tuples, and
dataclasses such as ``TrainState`` (fields in order).  ``None`` is an
empty subtree.  Leaf names are ``jax.tree_util.keystr`` paths:
``['layers']['attn']['wq']['w']``, ``.params``, ``[0]``."""

from __future__ import annotations

import dataclasses


def _children(tree):
    """[(key string, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def leaves_with_paths(tree, prefix: str = ""):
    """(keystr, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for key, child in children:
        yield from leaves_with_paths(child, prefix + key)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map_with_path(fn, tree, *rest, prefix: str = ""):
    """``fn(keystr, leaf, *matching leaves of rest)`` over the leaves of
    ``tree`` in flattening order, rebuilding the same containers."""
    if tree is None:
        return None
    if _children(tree) is None:
        return fn(prefix, tree, *rest)

    def sub(key, child, pick):
        return tree_map_with_path(fn, child, *(pick(r) for r in rest), prefix=prefix + key)

    if isinstance(tree, dict):
        return {k: sub(f"[{k!r}]", tree[k], lambda r, k=k: r[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(f"[{i}]", v, lambda r, i=i: r[i]) for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: sub(f".{f.name}", getattr(tree, f.name), lambda r, n=f.name: getattr(r, n))
        for f in dataclasses.fields(tree)
    })


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), rebuilding the same containers."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
