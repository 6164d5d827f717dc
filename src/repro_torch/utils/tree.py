"""Small tensor-tree utilities: the counterpart of ``repro/utils/tree.py``.

A tree is nested dicts, lists and tuples with tensors (or other values) at
the leaves, as the port's params, caches and train state are.  Leaves are
visited in ``jax.tree``'s order, dict keys sorted, and a leaf's path is its
keys joined by dots, as the JAX package writes it ("blocks.pos0.mixer.q.w").

Every function takes ``meta`` tensors.  A ``DTensor`` counts at its global
size; the bytes one device holds are ``distributed.sharding.
shard_bytes_per_device``'s.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any


def _items(tree: PyTree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_flatten_with_paths(tree: PyTree) -> list[tuple[str, Any]]:
    """Flatten to (dotted-path, leaf) pairs in a deterministic order."""
    out: list[tuple[str, Any]] = []

    def walk(t: PyTree, path: str) -> None:
        items = _items(t)
        if items is None:
            if t is not None:
                out.append((path, t))
            return
        for k, v in items:
            walk(v, f"{path}.{k}" if path else k)

    walk(tree, "")
    return out


def tree_leaves(tree: PyTree) -> list[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: PyTree, _path: str = "") -> PyTree:
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{_path}.{k}" if _path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, f"{_path}.{i}" if _path else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return tree if tree is None else fn(_path, tree)


def tree_map(fn: Callable[[Any], Any], tree: PyTree) -> PyTree:
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def _numel(leaf: Any) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


def tree_size_bytes(tree: PyTree) -> int:
    """Total bytes of all tensor leaves (global sizes; meta tensors too)."""
    return sum(_numel(leaf) * leaf.dtype.itemsize for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape") and hasattr(leaf, "dtype"))


def tree_param_count(tree: PyTree) -> int:
    return sum(_numel(leaf) for leaf in tree_leaves(tree) if hasattr(leaf, "shape"))


def tree_zeros_like(tree: PyTree, dtype: torch.dtype | None = None) -> PyTree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype, device=x.device), tree)


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def assert_no_nans(tree: PyTree, where: str = "") -> None:
    """Raise at the first floating leaf holding a NaN (one host sync a leaf)."""
    for path, leaf in tree_flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if bool(torch.isnan(leaf).any()):
                raise AssertionError(f"NaN at {where}:{path}")
