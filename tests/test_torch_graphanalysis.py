"""The port's per-device pricing of a sharded step (``core/graphanalysis.py``,
``core/roofline.py`` ``analyze_sharded``) against the JAX package's
``repro/core/hloanalysis.py``, on the CPU.

* The ring formulas price each of the five collectives as
  ``HloModuleAnalysis`` prices the same op in a hand-written HLO line, at
  group sizes 2, 4 and 16.
* Trip counts: an eager run sees every layer and every loop iteration, so
  depth 4 prices the layer part of depth 2 twice over, and a loop of 5
  sharded products on a fake 1 x 2 mesh counts its all-reduce 5 times (the
  JAX package skips that case on one device).
* One product on a fake 2 x 2 mesh is priced at 2·M·K·N / 4 a device: the
  product DTensor's sharding propagation runs on FakeTensor stand-ins at
  the global shapes is not counted.
* FLOPs against JAX: a reduced qwen2 prefill on a 1 x 1 mesh has the
  product FLOPs of the JAX prefill compiled on one CPU device, exactly,
  both the projections (dots without batch dims, ``mm`` here) and
  attention's (dots with batch dims, ``bmm`` here: at 32 tokens both
  packages' plain attention materialise the same scores).  The totals,
  which add one FLOP an element for the elementwise ops, differ where the
  two graphs differ (XLA's casts and fusions against aten's ops): within
  10 %.
* The captured-graph inventory's name map and its refusal without a graph.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.hloanalysis import HloModuleAnalysis, analyze_hlo_text  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import graphanalysis as ga  # noqa: E402
from repro_torch.core import roofline, sdfg  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

HLO_OPS = {"all-gather": "all-gather", "all-reduce": "all-reduce",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


def _hlo_line(op: str, n: int) -> str:
    attrs = ("source_target_pairs={{0,1}}" if op == "collective-permute"
             else f"replica_groups=[{16 // n},{n}]<=[16]")
    return "\n".join([
        "HloModule m",
        "",
        "ENTRY %main (p: f32[64,128]) -> f32[64,128] {",
        "  %p = f32[64,128] parameter(0)",
        f"  ROOT %c = f32[64,128] {op}(%p), {attrs}",
        "}",
    ])


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("op", list(HLO_OPS))
def test_ring_pricing_equals_the_jax_analyzer(op, n):
    want = analyze_hlo_text(_hlo_line(op, n), 16)["coll_by_op"][op]
    got = ga.collective_bytes(op, 64 * 128 * 4, n)
    assert got == pytest.approx(want, rel=1e-12)


def test_a_group_of_one_moves_nothing():
    assert all(ga.collective_bytes(op, 1024, 1) == 0 for op in ga.RING)
    assert set(ga.RING) == set(ga.COLLECTIVES) == set(ga.C10D_OPS.values())


@pytest.fixture
def fake_pg():
    """make(shape) -> a (data, model) mesh over a fake process group in this
    process; the group is taken down after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))

    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_one_product_is_priced_per_device_without_the_propagation_run(fake_pg):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = fake_pg((2, 2))
    M, K, N = 64, 128, 256
    a = distribute_tensor(torch.empty(M, K, device="meta"), mesh, [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(K, N, device="meta"), mesh, [Replicate(), Shard(1)])
    r = ga.analyze_sharded_step(lambda x, y: x @ y, a, b, n_devices=4)
    assert r["flops"] == 2 * M * K * N / 4
    assert [n.primitive for n in r["sdfg"].nodes] == ["mm"]
    assert r["coll_bytes"] == 0 and r["replicated"] == {}
    assert r["flop_counter_flops_per_dev"] == 2 * M * K * N / 4  # torch's, global / 4


def test_collectives_in_a_loop_are_counted_every_iteration(fake_pg):
    """5 products contracting over the model axis: an all-reduce each."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = fake_pg((1, 2))
    x = distribute_tensor(torch.empty(64, 128, device="meta"), mesh, [Replicate(), Replicate()])
    w = distribute_tensor(torch.empty(128, 128, device="meta"), mesh, [Replicate(), Shard(0)])

    def f(x, w):
        from torch.distributed.tensor import Replicate as R

        for _ in range(5):
            x = torch.tanh((x.redistribute(mesh, [R(), Shard(1)]) @ w)
                           .redistribute(mesh, [R(), R()]))
        return x.sum()

    r = ga.analyze_sharded_step(f, x, w, n_devices=2)
    assert r["coll_count"]["all-reduce"] == 5
    assert r["coll_by_op"]["all-reduce"] == 5 * ga.collective_bytes("all-reduce", 64 * 128 * 4, 2)


def _prefill_costs(mesh, layers: int) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops

    cfg = reduced(get_config("qwen2-0.5b"), layers=layers)
    params = shd.distribute(lm.abstract_params(cfg), lm.param_axes(cfg), shd.PARAM_RULES, mesh)
    tok = shd.distribute({"t": torch.zeros(4, 16, dtype=torch.int32, device="meta")},
                         {"t": "batch,seq"}, shd.ACT_RULES, mesh)["t"]
    with ops.impl_scope("plain"), implicit_replication(), torch.no_grad():
        return ga.analyze_sharded_step(lambda p, t: lm.prefill(p, cfg, t)[0], params, tok,
                                       n_devices=mesh.size())


def test_depth_four_prices_the_layer_part_of_depth_two_twice(fake_pg):
    """The two layers depth 4 adds to depth 2 cost twice the one depth 3
    adds: every layer is run and priced, none multiplied."""
    mesh = fake_pg((2, 2))
    c2, c3, c4 = (_prefill_costs(mesh, n) for n in (2, 3, 4))
    for key in ("flops", "mem_bytes", "coll_bytes"):
        layer = c3[key] - c2[key]
        assert layer > 0, key
        assert c4[key] - c2[key] == 2 * layer, key
    assert c4["coll_count"]["all-gather"] > c2["coll_count"]["all-gather"]


def test_prefill_flops_on_a_one_by_one_mesh_equal_the_jax_analyzer():
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import destroy_mesh, make_local_mesh

    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")), scan_layers=False)
    cfg = reduced(get_config("qwen2-0.5b"))
    B, S = 2, 32
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    hlo = jax.jit(lambda p, t: jax_lm.prefill(p, jcfg, t)[0]).lower(
        jp, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    jr = analyze_hlo_text(hlo, 1)
    mod = HloModuleAnalysis(hlo, 1)
    dots = {True: 0.0, False: 0.0}  # by: has batch dims
    for instrs in mod.comps.values():
        shapes = {i.name: i.type_str for i in instrs}
        for i in instrs:
            if i.opcode == "dot":
                dots["lhs_batch_dims" in i.rest] += mod._dot_flops(i, shapes)
    mesh = make_local_mesh("cpu")
    try:
        params = shd.distribute(params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu"),
                                lm.param_axes(cfg), shd.PARAM_RULES, mesh)
        tok = shd.distribute({"t": torch.zeros(B, S, dtype=torch.int32)}, {"t": "batch,seq"},
                             shd.ACT_RULES, mesh)["t"]
        with implicit_replication(), torch.no_grad():
            r = ga.analyze_sharded_step(lambda p, t: lm.prefill(p, cfg, t)[0], params, tok,
                                        n_devices=1)
    finally:
        destroy_mesh()
    products = {"mm": 0.0, "bmm": 0.0}
    for n in r["sdfg"].nodes:
        if n.product:
            products[n.primitive] += n.flops
    assert products["mm"] == dots[False]
    assert products["bmm"] == dots[True]
    assert r["flops"] == pytest.approx(jr["flops"], rel=0.10)
    assert r["coll_bytes"] == 0  # one device: nothing crosses


def test_analyze_sharded_keeps_the_jax_record_keys(fake_pg):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = fake_pg((2, 2))
    a = distribute_tensor(torch.empty(64, 128, device="meta"), mesh, [Shard(0), Shard(1)])
    b = distribute_tensor(torch.empty(128, 32, device="meta"), mesh, [Replicate(), Shard(0)])
    rec = roofline.analyze_sharded(lambda x, y: torch.tanh(x @ y), (a, b), mesh)
    for key in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev",
                "collective_breakdown", "xla_cost_flops_per_dev", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "step_time_bound_s", "memory_analysis"):
        assert key in rec, key
    assert rec["xla_cost_flops_per_dev"] is None
    assert rec["collective_bytes_per_dev"] > 0  # the partial sum over the model axis
    assert rec["collective_bytes_per_dev"] == sum(rec["collective_breakdown"].values())
    assert rec["t_collective_s"] == rec["collective_bytes_per_dev"] / 450e9
    assert rec["memory_analysis"]["argument_bytes"] == (32 * 64 + 64 * 32) * 4
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_kernel_names_map_to_the_port_kernels():
    names = {
        "void (anonymous namespace)::flash_fwd_mma<128>(bf16 const*)": "flash_attention",
        "void decode_split_mma<64>(x)": "decode_attention",
        "decode_combine_kernel<float, true>(...)": None,
        "flash_bwd_dq_wide(x)": "flash_attention_bwd",
        "flash_bwd_dkdv_wide(x)": None,
        "rmsnorm_rows<__nv_bfloat16, 1, true>(...)": "rmsnorm",
        "rmsnorm_bwd_fused<float, 2>(...)": "rmsnorm_bwd",
        "gmm_mma<8>(...)": "moe_gmm",
        "void (anonymous namespace)::gmm_dgrad_gated<__nv_bfloat16, 1, true>(x)": "moe_gmm_bwd",
        "gmm_dgrad<float, false>(x)": "moe_gmm_bwd",
        "gmm_wgrad<__nv_bfloat16, true>(x)": "moe_gmm_bwd",
        "ampere_bf16_s16816gemm_bf16_128x64": None,
    }
    for name, port in names.items():
        assert ga.port_kernel(name) == port, name
    graph = sdfg.SDFG([sdfg.Node(i, p, sdfg.TENSOR_CORE, 0.0, 0.0, "r", kernel=True)
                       for i, p in enumerate(["decode_attention", "decode_attention_stats",
                                              "rmsnorm"])], [])
    assert ga.kernel_nodes(graph) == {"decode_attention": 2, "rmsnorm": 1}


def test_captured_kernels_needs_a_captured_graph():
    from repro_torch.serving.compiled import Graphs

    step = Graphs(torch.device("cpu")).step(lambda x: x + 1)
    step(torch.zeros(2))
    with pytest.raises(ValueError, match="not captured"):
        ga.captured_kernels(step)
