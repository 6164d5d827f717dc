"""The port's logical-axis sharding (``repro_torch.distributed``) against
the JAX package's, on the CPU.

Every leaf's logical axes equal the JAX package's (params, train state,
caches of all 10 archs), and so does every leaf's spec: ``spec_for`` /
``tree_specs`` give the same per-dim assignment as JAX's ``PartitionSpec``
at the production 16 x 16 and 2 x 16 x 16 meshes, under every rule set
``rules_for_shape`` makes (train, prefill, decode at a full and at a
one-row batch, weight-stationary or not).  A mapping {axis: size} stands
in for both meshes: ``spec_for`` reads only the axis sizes.  Then the JAX
``tests/test_sharding.py`` cases, ported; a dim over two mesh axes split
as JAX splits it (shard ``i`` pod-major); and the placements, the
``distribute`` / ``reshard`` round trip and ``constrain`` on a fake
process group of 4 ranks in this process, taken down after each test.
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.distributed import sharding as jax_shd  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.training.step import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training.step import abstract_train_state as jax_abstract_train_state  # noqa: E402
from repro.training.step import train_state_axes as jax_train_state_axes  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs, reduced  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training.step import TrainConfig, abstract_train_state, train_state_axes  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_mesh(shape: dict):
    """What JAX's spec_for / rules_for_shape read of a mesh: its axis sizes."""
    return types.SimpleNamespace(shape=dict(shape))


def _rule_sets(cfg, mesh_shape):
    """(name, port rules, JAX rules) for every rules_for_shape case."""
    out = []
    jmesh = _jax_mesh(mesh_shape)
    cases = [("train", JAX_SHAPES["train_4k"], False), ("prefill", JAX_SHAPES["prefill_32k"], False),
             ("decode", JAX_SHAPES["decode_32k"], False), ("decode_ws", JAX_SHAPES["decode_32k"], True),
             ("long", JAX_SHAPES["long_500k"], False), ("long_ws", JAX_SHAPES["long_500k"], True)]
    for name, shape, ws in cases:
        kw = dict(global_batch=shape.global_batch, seq_len=shape.seq_len,
                  n_kv_heads=cfg.n_kv_heads, weight_stationary=ws)
        out.append((name, shd.rules_for_shape(shape.kind, mesh=mesh_shape, **kw),
                    jax_shd.rules_for_shape(shape.kind, mesh=jmesh, **kw)))
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """{tree name: (port axes, port shapes, JAX axes, JAX shapes)} at full size."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    return {
        "params": (lm.param_axes(cfg), lm.abstract_params(cfg), jax_lm.param_axes(jcfg),
                   jax_lm.abstract_params(jcfg)),
        "state": (train_state_axes(cfg), abstract_train_state(cfg, TrainConfig()),
                  jax_train_state_axes(jcfg), jax_abstract_train_state(jcfg, JaxTrainConfig())),
        "caches": (lm.cache_axes(cfg), lm.init_caches(cfg, 2, 64, "meta"),
                   jax_lm.cache_axes(jcfg), jax_lm.abstract_caches(jcfg, 2, 64)),
    }


@pytest.mark.parametrize("arch", list_archs())
def test_axes_and_shapes_equal_jax(arch):
    """Every leaf of params, train state and caches: the same path, logical
    axes, shape and dtype as the JAX package's."""
    for name, (axes, shapes, jaxes, jshapes) in _trees(arch).items():
        assert _flat(axes) == _flat(jaxes), (arch, name)
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(shapes).items()}
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jshapes).items()}
        assert got == want, (arch, name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_jax_every_leaf_every_rule_set(arch, mesh):
    mshape = MESHES[mesh]
    cfg = get_config(arch)
    for rule_name, rules, jrules in _rule_sets(cfg, mshape):
        assert rules.param == jrules.param and rules.act == jrules.act, (arch, mesh, rule_name)
        for name, (axes, shapes, jaxes, jshapes) in _trees(arch).items():
            rule_set = rules.act if name == "caches" else rules.param
            jrule_set = jrules.act if name == "caches" else jrules.param
            got = _flat(shd.tree_specs(axes, shapes, rule_set, mshape))
            want = jax.tree.map(lambda a, s: tuple(jax_shd.spec_for(tuple(s.shape), a, jrule_set,
                                                                    _jax_mesh(mshape))),
                                jaxes, jshapes)
            assert got == _flat(want), (arch, mesh, rule_name, name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_bytes_per_device_equal_jax(mesh):
    mshape = MESHES[mesh]
    for arch in ("qwen2-0.5b", "deepseek-moe-16b", "jamba-1.5-large"):
        axes, shapes, jaxes, jshapes = _trees(arch)["state"]
        specs = shd.tree_specs(axes, shapes, shd.PARAM_RULES, mshape)
        jspecs = jax_shd.tree_specs(jaxes, jshapes, jax_shd.PARAM_RULES, _jax_mesh(mshape))
        assert shd.shard_bytes_per_device(shapes, specs, mshape) == \
            jax_shd.shard_bytes_per_device(jshapes, jspecs, _jax_mesh(mshape)), (arch, mesh)


def test_the_rule_tables_are_the_jax_ones():
    assert shd.PARAM_RULES == jax_shd.PARAM_RULES and shd.ACT_RULES == jax_shd.ACT_RULES
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in JAX_SHAPES.items()}


# --- the JAX package's tests/test_sharding.py, ported -----------------------


def test_basic_param_specs():
    mesh = {"data": 4, "model": 2}
    assert shd.spec_for((256, 64), "vocab,embed", shd.PARAM_RULES, mesh) == \
        tuple(P("model", "data"))


def test_divisibility_fallback_drops_mapping():
    mesh = {"data": 4, "model": 16}
    # 15 heads on a 16-way model axis: dropped (smollm case)
    assert shd.spec_for((960, 15, 64), "embed,heads,head_dim", shd.PARAM_RULES, mesh) == \
        tuple(P("data"))
    assert shd.spec_for((960, 2560), "embed,mlp", shd.PARAM_RULES, mesh) == \
        tuple(P("data", "model"))


def test_axis_used_once():
    assert shd.spec_for((8, 8), "a,b", {"a": "model", "b": "model"},
                        {"data": 4, "model": 2}) == tuple(P("model"))


def test_multi_axis_assignment():
    mesh = {"pod": 2, "data": 4, "model": 2}
    assert shd.spec_for((16, 128), "batch,seq", shd.ACT_RULES, mesh) == tuple(P(("pod", "data")))


def test_rules_for_shape_decode_overrides():
    mesh = {"data": 4, "model": 16}
    r = shd.rules_for_shape("decode", global_batch=128, seq_len=32768, mesh=mesh, n_kv_heads=8)
    assert r.act["cache_seq"] == "model" and r.act["kv_heads"] is None
    r = shd.rules_for_shape("decode", global_batch=128, seq_len=32768, mesh=mesh, n_kv_heads=16)
    assert r.act["cache_seq"] is None
    r = shd.rules_for_shape("decode", global_batch=1, seq_len=524288, mesh=mesh, n_kv_heads=16)
    assert r.act["cache_seq"] == "data" and r.act["batch"] is None


def test_tree_specs_align_with_param_tree():
    cfg = reduced(get_config("deepseek-moe-16b"))
    axes, params = lm.param_axes(cfg), lm.abstract_params(cfg)
    specs = _flat(shd.tree_specs(axes, params, shd.PARAM_RULES, {"data": 2, "model": 2}))
    assert set(specs) == set(_flat(params))


def test_cache_axes_align_with_caches():
    for arch in ("gemma3-4b", "jamba-1.5-large", "rwkv6-7b"):
        cfg = reduced(get_config(arch))
        axes, caches = _flat(lm.cache_axes(cfg)), _flat(lm.init_caches(cfg, 2, 32, "meta"))
        assert set(axes) == set(caches), arch
        for k in axes:
            assert len(axes[k].split(",")) == caches[k].dim(), (arch, k)
        jcfg = jax_reduced(jax_get_config(arch))
        assert axes == _flat(jax_lm.cache_axes(jcfg)), arch


def test_shard_bytes_per_device():
    mesh = {"data": 4, "model": 2}
    t = {"w": torch.empty(64, 64, device="meta")}
    assert shd.shard_bytes_per_device(t, {"w": ("data", "model")}, mesh) == 64 * 64 * 4 // 8


# --- placements on a DeviceMesh ----------------------------------------------


@pytest.fixture
def fake_mesh():
    """A 2 x 2 (data, model) mesh over a fake process group of 4 ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_a_dim_over_two_mesh_axes_splits_as_jax_splits_it():
    """Shard i of batch over ("pod", "data") holds the rows JAX gives tile i
    (pod-major), at every device of a 2 x 4 x 2 mesh."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    from jax.sharding import AbstractMesh, NamedSharding

    shape, names = (2, 4, 2), ("pod", "data", "model")
    spec = shd.spec_for((16, 8), "batch,mlp", {**shd.ACT_RULES, "mlp": "model"},
                        dict(zip(names, shape)))
    assert spec == (("pod", "data"), "model")
    mesh = types.SimpleNamespace(mesh_dim_names=names, ndim=3)
    pl = shd.placements(spec, mesh)
    hlo = NamedSharding(AbstractMesh(shape, names), P(*spec))._to_xla_hlo_sharding(2)
    tiles = hlo.tile_assignment_dimensions()
    order = list(hlo.tile_assignment_devices())  # device id at each tile, row-major
    for dev in range(16):
        coord = [dev // 8, (dev // 2) % 4, dev % 2]
        local, offset = _compute_local_shape_and_global_offset((16, 8), shape, coord, pl)
        tile = order.index(dev)
        assert offset == ((tile // tiles[1]) * 2, (tile % tiles[1]) * 4), dev
        assert local == (2, 4)


def test_placements_refuse_a_dim_against_the_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), ndim=2)
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("model", "data"),), mesh)


def test_distribute_drops_an_uneven_mapping_before_dtensor_sees_it(fake_mesh):
    """smollm's 15 heads on a 2-way model axis: replicated there, not padded."""
    from torch.distributed.tensor import Replicate, Shard

    t = {"w": torch.empty(960, 15, 64, device="meta")}
    d = shd.distribute(t, {"w": "embed,heads,head_dim"}, shd.PARAM_RULES, fake_mesh)["w"]
    assert list(d.placements) == [Shard(0), Replicate()]
    assert tuple(d.to_local().shape) == (480, 15, 64)
    s = shd.tree_shardings({"w": "embed,mlp"}, {"w": torch.empty(6, 4, device="meta")},
                           shd.PARAM_RULES, fake_mesh)["w"]
    assert s.mesh is fake_mesh and s.placements == (Shard(0), Shard(1))


def test_reshard_keeps_param_leaves_and_round_trips(fake_mesh):
    axes = {"w": "embed,mlp", "b": "mlp"}
    tree = {"w": torch.randn(4, 6).requires_grad_(True), "b": torch.zeros(6)}
    sharded, shardings = shd.reshard(tree, axes, shd.PARAM_RULES, fake_mesh)
    assert sharded["w"].is_leaf and sharded["w"].requires_grad and not sharded["b"].requires_grad
    assert set(shardings) == {"w", "b"}
    whole, none = shd.reshard(sharded, axes, shd.PARAM_RULES, None)
    assert none is None and whole["w"].is_leaf and whole["w"].requires_grad
    assert tuple(whole["w"].shape) == (4, 6)


def test_constrain_is_a_no_op_without_a_mesh_and_redistributes_under_one(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.constrain import ambient_mesh, constrain, mesh_scope

    x = torch.randn(4, 8, 2, 3)
    assert constrain(x, "batch", "seq", "heads", "head_dim") is x and ambient_mesh() is None
    d = shd.distribute({"x": x}, {"x": ",,,"}, shd.ACT_RULES, fake_mesh)["x"]
    assert constrain(d, "batch", "seq", "heads", "head_dim") is d  # no mesh in scope
    with mesh_scope(fake_mesh):
        assert ambient_mesh() is fake_mesh
        c = constrain(d, "batch", "seq", "heads", "head_dim")
        assert list(c.placements) == [Shard(0), Shard(2)]
        c2 = constrain(d, "batch", "seq", "kv_heads", None, rules={"batch": "data"})
        assert list(c2.placements) == [Shard(0), Replicate()]
    assert ambient_mesh() is None
