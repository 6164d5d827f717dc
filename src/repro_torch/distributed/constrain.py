"""Activation sharding constraints by logical axis names (mesh-optional):
the counterpart of ``repro/distributed/constrain.py``.

``constrain(x, "batch", "seq", "heads", "head_dim")`` redistributes a
``DTensor`` to the placements that ``ACT_RULES`` give against the ambient
mesh, divisibility-safe (a non-divisible mapping is dropped per dim, as for
parameters).  The ambient mesh is set by :func:`mesh_scope`, the
counterpart of JAX's ``with mesh:``; with none set, or for a plain tensor,
``constrain`` is a no-op (one card, the CPU tests).

:func:`replicated` is the explicit counterpart of what GSPMD does silently
where it has no better layout: an op without a DTensor sharding strategy
(or one whose operands must be whole, such as an in-place write into a
cache) gets every DTensor operand redistributed to ``Replicate()`` first,
so a dry-run prices that all-gather instead of losing the mesh.
"""
from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional

import torch

from repro_torch.distributed.sharding import ACT_RULES, placements, spec_for
from repro_torch.nn.core import axes_str

_SCOPES = threading.local()  # per thread, as JAX's ambient mesh: .stack of (mesh, act rules)


def _stack() -> list:
    if not hasattr(_SCOPES, "stack"):
        _SCOPES.stack = []
    return _SCOPES.stack


def ambient_mesh() -> Optional[Any]:
    stack = _stack()
    return stack[-1][0] if stack else None


def ambient_act_rules() -> dict:
    """The activation rules of the ambient scope (``ACT_RULES`` unless the
    scope was given others, e.g. a decode cell's ``rules_for_shape``)."""
    stack = _stack()
    return (stack[-1][1] if stack else None) or ACT_RULES


@contextmanager
def mesh_scope(mesh: Optional[Any], act_rules: Optional[dict] = None
               ) -> Iterator[Optional[Any]]:
    """Make ``mesh`` (a ``DeviceMesh`` with named dims, or None for no mesh)
    the ambient mesh inside the block, with ``act_rules`` for the state a
    step creates (:func:`place`)."""
    _stack().append((mesh, act_rules))
    try:
        yield mesh
    finally:
        _stack().pop()


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing DTensor's module:
    until something has, no tensor can be one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, *axes: Optional[str], rules: Optional[dict] = None) -> torch.Tensor:
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = spec_for(tuple(x.shape), axes_str(tuple(axes)), rules or ACT_RULES, mesh)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def place(tree: Any, tree_axes: Any, mesh: Optional[Any] = None) -> Any:
    """``tree``'s tensors (state a step creates, such as a prefill's fresh
    caches) as DTensors on ``mesh`` (default: the ambient one) under the
    ambient activation rules; as it is without a mesh."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return tree
    from repro_torch.distributed.sharding import distribute

    return distribute(tree, tree_axes, ambient_act_rules(), mesh)


def replicated(*xs: Any) -> Any:
    """Each ``DTensor`` among ``xs`` redistributed to ``Replicate()`` on
    every mesh dim (an all-gather of its shards); anything else as it is.
    One argument gives one result, several a tuple."""
    from torch.distributed.tensor import Replicate

    out = []
    for x in xs:
        if is_dtensor(x) and any(not p.is_replicate() for p in x.placements):
            x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        out.append(x)
    return out[0] if len(out) == 1 else tuple(out)


def reduce_partials(x: Any) -> Any:
    """A ``DTensor`` whose placements hold a pending reduction (``Partial``,
    e.g. the masked lookup of a vocab-sharded embedding) with that
    reduction done now (``Replicate()`` on those mesh dims); anything else
    as it is.  DTensor keeps one mask per masked lookup, so two tensors
    derived from it cannot both be reduced later."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])
