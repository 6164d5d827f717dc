"""Logical-axis -> mesh-axis sharding rules (MaxText-style, divisibility-safe):
the counterpart of ``repro/distributed/sharding.py``.

Every parameter / activation / cache leaf carries logical axis names
(``nn.core.AxesFactory``, ``models.lm.cache_axes``).  A *rule set* maps
logical names to mesh axes:

  * ``data``  doubles as the FSDP axis: parameter 'embed'/'mlp'-class dims are
    sharded over it (ZeRO-3).
  * ``model`` is the TP/EP axis: heads, ffn width, vocab, experts.
  * ``pod``   is the DCN axis: pure data parallelism (batch); parameters are
    replicated across pods.

Divisibility fallback: a mapping is *dropped per leaf* when the dim size is
not divisible by the mesh axis (smollm's 15 heads on a 16-way model axis:
attention params stay replicated on 'model' while its FFN shards).  The
drop happens here, before a ``DTensor`` sees the placement: DTensor itself
would accept an uneven dimension and pad its last shards.

:func:`spec_for` returns the JAX package's ``PartitionSpec`` as a plain
tuple, one entry per dim (``None``, a mesh axis, or a tuple of them, major
to minor), trailing ``None``s stripped, so the two packages compare leaf
for leaf.  :func:`placements` turns it into ``Shard(d)`` / ``Replicate()``
per mesh dimension of a ``torch.distributed`` ``DeviceMesh``, PyTorch's
counterpart of GSPMD's ``NamedSharding``; DTensor's sharding propagation
then inserts the collectives that XLA inserts in the JAX package.  A dim
over two mesh axes (``batch: ("pod", "data")``) is ``Shard(d)`` on both, and
DTensor splits it in mesh order, so shard ``i`` (pod-major) holds the rows
JAX gives device ``i``; an order against the mesh's is refused.

A mesh argument is a ``DeviceMesh`` with ``mesh_dim_names``, or a mapping
{axis name: size} where only the rule logic is wanted (no process group).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

from repro_torch.nn.core import parse_axes
from repro_torch.utils.tree import tree_leaves

PyTree = Any
Spec = tuple  # per dim: None | mesh axis | tuple of mesh axes

# Rule sets: logical axis -> mesh axis (or tuple of mesh axes).
# fmt: off
PARAM_RULES: dict[str, Any] = {
    "vocab":      "model",   # TP: embedding/unembedding vocab-sharded
    "heads":      "model",   # TP: attention heads
    "kv_heads":   "model",
    "mlp":        "model",   # TP: FFN width / mamba d_inner
    "expert_mlp": "model",   # fallback when 'experts' itself can't shard
    "experts":    "model",   # EP
    "embed":      "data",    # FSDP (ZeRO-3) over the data axis
    "embed_out":  None,
    "head_dim":   None,
    "layers":     None,      # the stacked period axis
}
ACT_RULES: dict[str, Any] = {
    "batch":      ("pod", "data"),
    "seq":        None,
    "embed":      None,
    "heads":      "model",
    "kv_heads":   "model",
    "mlp":        "model",
    "experts":    "model",
    "vocab":      "model",
    "cache_seq":  None,
}
# fmt: on


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    param: dict[str, Any]
    act: dict[str, Any]

    def with_overrides(self, *, param=None, act=None) -> "ShardingRules":
        return ShardingRules({**self.param, **(param or {})}, {**self.act, **(act or {})})


DEFAULT_RULES = ShardingRules(PARAM_RULES, ACT_RULES)

MeshLike = Union[Mapping[str, int], Any]  # a DeviceMesh or {axis: size}


def mesh_shape(mesh: MeshLike) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping, as it is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a sharding mesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _axis_size(shape: Mapping[str, int], assignment) -> int:
    if assignment is None:
        return 1
    if isinstance(assignment, str):
        assignment = (assignment,)
    size = 1
    for a in assignment:
        size *= shape.get(a, 1)
    return size


def spec_for(shape: tuple[int, ...], axes_s: str, rules: Mapping[str, Any],
             mesh: MeshLike) -> Spec:
    """A PartitionSpec tuple, dropping any non-divisible / absent / reused
    mapping."""
    mshape = mesh_shape(mesh)
    axes = parse_axes(axes_s)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {tuple(shape)}")
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, axes):
        assignment = rules.get(name) if name else None
        if assignment is None:
            parts.append(None)
            continue
        if isinstance(assignment, str):
            assignment = (assignment,)
        # keep only mesh axes present, unused so far, and divisible
        kept = []
        remaining = dim
        for a in assignment:
            if a not in mshape or a in used:
                continue
            if remaining % mshape[a] == 0:
                kept.append(a)
                remaining //= mshape[a]
        used.update(kept)
        parts.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    while parts and parts[-1] is None:  # trailing Nones stripped, as P(...) prints
        parts.pop()
    return tuple(parts)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(p is None or isinstance(p, (str, tuple)) for p in x)


def placements(spec: Spec, mesh: Any) -> list:
    """``Shard(d)`` / ``Replicate()`` for each mesh dimension of a
    ``DeviceMesh``, from a :func:`spec_for` tuple."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec}: mesh axes {axes} against the mesh's order "
                             f"{names} (DTensor splits a dim in mesh order)")
        for i in idx:
            out[i] = Shard(d)
    return out


def _map2(fn, axes_tree: PyTree, shapes_tree: PyTree) -> PyTree:
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(shapes_tree):
            raise ValueError(f"axes keys {sorted(axes_tree)} vs {sorted(shapes_tree)}")
        return {k: _map2(fn, axes_tree[k], shapes_tree[k]) for k in axes_tree}
    return fn(axes_tree, shapes_tree)


def tree_specs(tree_axes: PyTree, tree_shapes: PyTree, rules: Mapping[str, Any],
               mesh: MeshLike) -> PyTree:
    """Map (axes-string tree, shaped tree) -> spec tree."""
    return _map2(lambda a, leaf: spec_for(tuple(leaf.shape), a, rules, mesh), tree_axes,
                 tree_shapes)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one placement per mesh dim: the counterpart of JAX's
    ``NamedSharding``."""

    mesh: Any
    placements: tuple

    def distribute(self, t):
        """The whole tensor ``t`` (the same on every rank) as a DTensor."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, list(self.placements))


def tree_shardings(tree_axes: PyTree, tree_shapes: PyTree, rules: Mapping[str, Any],
                   mesh: Any) -> PyTree:
    """Map (axes-string tree, shaped tree) -> :class:`Sharding` tree on ``mesh``."""
    return _map2(lambda a, leaf: Sharding(mesh, tuple(placements(
        spec_for(tuple(leaf.shape), a, rules, mesh), mesh))), tree_axes, tree_shapes)


def _keep_leaf(d, t):
    """``d`` as a leaf that requires grad where ``t`` did (a param)."""
    return d.detach().requires_grad_(True) if t.requires_grad else d


def distribute(tree: PyTree, tree_axes: PyTree, rules: Mapping[str, Any], mesh: Any) -> PyTree:
    """Each tensor of ``tree`` as a ``DTensor`` on ``mesh`` under the rules
    (``distribute_tensor``: every rank passes the same whole tensor).  A
    leaf that requires grad stays a leaf that does."""
    shardings = tree_shardings(tree_axes, tree, rules, mesh)
    return _map2(lambda t, s: _keep_leaf(s.distribute(t.detach()), t), tree, shardings)


def gather(tree: PyTree) -> PyTree:
    """Each DTensor of ``tree`` as its whole tensor (``full_tensor``), on
    every rank; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    def one(t):
        return _keep_leaf(t.full_tensor(), t) if isinstance(t, DTensor) else t

    return _map_tree(one, tree)


def reshard(tree: PyTree, tree_axes: PyTree, rules: Mapping[str, Any],
            mesh: Optional[Any]) -> tuple[PyTree, Optional[PyTree]]:
    """``tree`` moved onto ``mesh`` under the rules (None: whole tensors,
    no mesh) -> (tree, its shardings): a ``Supervisor.resize`` reshard_fn
    once the axes and rules are bound."""
    whole = gather(tree)
    if mesh is None:
        return whole, None
    return (distribute(whole, tree_axes, rules, mesh),
            tree_shardings(tree_axes, whole, rules, mesh))


def _map_tree(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_bytes_per_device(tree_shapes: PyTree, tree_specs_: PyTree, mesh: MeshLike) -> int:
    """Napkin per-device bytes for a sharded tree (dry-run feasibility)."""
    mshape = mesh_shape(mesh)
    total = 0
    specs = [s for s in _flat_specs(tree_specs_)]
    for leaf, spec in zip(tree_leaves(tree_shapes), specs, strict=True):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        denom = 1
        for part in spec:
            for a in ((part,) if isinstance(part, str) else part) if part else ():
                denom *= mshape[a]
        total += n * leaf.dtype.itemsize // denom
    return total


def _flat_specs(tree: PyTree) -> list:
    """Spec leaves in ``tree_leaves`` order (sorted dict keys); a spec is a tuple."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat_specs(tree[k])]
    if not _is_spec(tree):
        raise TypeError(f"not a spec: {tree!r}")
    return [tree]


def rules_for_shape(
    kind: str,
    *,
    global_batch: int,
    seq_len: int,
    mesh: MeshLike,
    n_kv_heads: int,
    weight_stationary: bool = False,
) -> ShardingRules:
    """Shape-conditional rule adjustments (the JAX package's production
    heuristics, unchanged).

    * decode shapes: KV caches shard kv_heads over 'model' when divisible,
      else the cache *sequence* dim goes to 'model' (flash-decoding split-KV).
    * long-context (batch < data axis): sequence-parallel decode: the cache
      seq dim shards over 'data' (and kv-head sharding stays on 'model').
    * ``weight_stationary`` (decode only): 2D-shard the weights' output dims
      over (data x model), replicate the per-token activations over 'data',
      and shard caches over spare axes: weights never move.
    """
    del seq_len  # the JAX signature's; no rule reads it
    rules = DEFAULT_RULES
    if kind not in ("decode",):
        return rules
    mshape = mesh_shape(mesh)
    data_ax = mshape.get("data", 1)
    model_ax = mshape.get("model", 1)
    batch_axes = _axis_size(mshape, ACT_RULES["batch"])
    act: dict[str, Any] = {}
    if weight_stationary:
        act["batch"] = ("pod",) if "pod" in mshape else None
        act["mlp"] = ("data", "model")
        act["experts"] = "model"
        if n_kv_heads % model_ax == 0:
            act["cache_seq"] = "data"
        else:
            act["cache_seq"] = ("data", "model")
            act["kv_heads"] = None
        param = {
            "embed": None,  # no FSDP at decode: weights stay put
            "mlp": ("data", "model"),
            "expert_mlp": "data",  # experts already on 'model'
        }
        return rules.with_overrides(param=param, act=act)
    if global_batch < batch_axes:
        # SP: batch can't fill (pod, data): put cache seq on 'data' instead.
        act["batch"] = None if global_batch < data_ax else ("pod",)
        act["cache_seq"] = "data"
        if n_kv_heads % model_ax != 0:
            act["cache_seq"] = ("data", "model")
            act["kv_heads"] = None
    elif n_kv_heads % model_ax != 0:
        # GQA too narrow for TP: split-KV over 'model' instead of replicating.
        act["cache_seq"] = "model"
        act["kv_heads"] = None
    return rules.with_overrides(act=act)


def axes_tuple(assignment: Optional[Any]) -> tuple[str, ...]:
    """A rule's assignment (None, an axis, or a tuple of axes) as a tuple."""
    if assignment is None:
        return ()
    return (assignment,) if isinstance(assignment, str) else tuple(assignment)
