"""The port's roofline and SDFG against the JAX package's, on the CPU.

``count_params`` (active and not) and ``model_flops`` equal
``repro.core.roofline``'s exactly for every arch the port can initialise
on the meta device, at full size and for every ``SHAPES`` entry (the JAX
side from ``jax.eval_shape``).  The SDFG of a reduced qwen2 loss step has
the JAX SDFG's MXU FLOPs as its product FLOPs (1e-6 relative), by named
scope, and the JAX package's scope regions.  Classification, bytes, the
H100 spec and the attention pair counts the kernel notes use.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import roofline as jax_roofline  # noqa: E402
from repro.core import sdfg as jax_sdfg  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.core import roofline, sdfg  # noqa: E402
from repro_torch.core.scopes import scope  # noqa: E402
from repro_torch.hw import specs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

REL = 1e-6


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(port meta params, JAX abstract params) of the full-size arch."""
    params = lm.init_params(get_config(arch), 0, device="meta")
    jparams = jax.eval_shape(lambda: jax_lm.init_params(jax_get_config(arch),
                                                         jax.random.PRNGKey(0)))
    return params, jparams


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_count_params_equals_jax(arch, active):
    params, jparams = _abstract(arch)
    assert all(t.device.type == "meta" for t in roofline_leaves(params))
    got = roofline.count_params(params, active=active, cfg=get_config(arch))
    want = jax_roofline.count_params(jparams, active=active, cfg=jax_get_config(arch))
    assert got == want > 0


def roofline_leaves(tree):
    return [t for _, t in roofline._named_leaves(tree)]


@pytest.mark.parametrize("shape", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equals_jax(arch, shape):
    params, jparams = _abstract(arch)
    got = roofline.model_flops(get_config(arch), roofline.SHAPES[shape], params)
    want = jax_roofline.model_flops(jax_get_config(arch), JAX_SHAPES[shape], jparams)
    assert got == want > 0


def test_shapes_copy_jax():
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in roofline.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in JAX_SHAPES.items()}


def _loss_graphs():
    jcfg, cfg = jax_reduced(jax_get_config("qwen2-0.5b")), reduced(get_config("qwen2-0.5b"))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    labels = np.roll(toks, -1, 1)
    jg = jax_sdfg.extract(lambda q, t, y: jax_lm.loss_fn(q, jcfg, t, y)[0], jp,
                          jnp.asarray(toks), jnp.asarray(labels))
    g = sdfg.extract(lambda: lm.loss_fn(p, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(labels))[0])
    return jg, g


def _fold(region: str) -> str:
    """JAX names a jitted ``jnp.einsum``'s equations by its spec alone (the
    inner jaxpr restarts the name stack); in this model they are the
    attention mixer's two products."""
    return "pos0_ga_dense/mixer_ga" if "->" in region else region


def test_loss_sdfg_product_flops_equal_jax_mxu_flops():
    jg, g = _loss_graphs()
    jmxu = sum(n.flops for n in jg.nodes if n.backend == jax_sdfg.MXU)
    assert g.product_flops() == pytest.approx(jmxu, rel=REL)
    by_region, jby_region = {}, {}
    for n in g.nodes:
        if n.product:
            by_region[n.region] = by_region.get(n.region, 0.0) + n.flops
    for n in jg.nodes:
        if n.backend == jax_sdfg.MXU:
            r = _fold(n.region)
            jby_region[r] = jby_region.get(r, 0.0) + n.flops
    assert by_region.keys() == jby_region.keys()
    for r, f in jby_region.items():
        assert by_region[r] == pytest.approx(f, rel=REL), r


def test_loss_sdfg_has_the_jax_regions():
    """Every JAX scope region is a port region, and the port's regions are
    the JAX ones plus ``embed`` (whose one gather JAX's jitted ``jnp.take``
    moves out of the scope)."""
    jg, g = _loss_graphs()
    jregions = {_fold(r) for r in jg.regions()}
    assert set(g.regions()) == jregions | {"embed"}
    assert g.regions()["final_norm"].nodes > 0
    assert all(n.backend != sdfg.HOST for n in g.nodes)


def test_classification_and_bytes():
    a = torch.ones(4, 8, dtype=torch.bfloat16)
    b = torch.ones(8, 2, dtype=torch.bfloat16)

    def fn():
        with scope("blk"):
            a @ b  # bf16 product: tensor cores, 2 m n k FLOPs
            a.float() @ b.float()  # f32 product: CUDA cores
            a.t()  # a view moves nothing
            (a.float() + 1.0).sum().item()  # elementwise, reduction, a sync
        torch.zeros(3).expand(5, 3).clone()  # a broadcast input: its distinct elements

    g = sdfg.extract(fn)
    nodes = {(n.primitive, n.backend) for n in g.nodes}
    assert ("mm", sdfg.TENSOR_CORE) in nodes and ("mm", sdfg.CUDA_CORE) in nodes
    mm = [n for n in g.nodes if n.primitive == "mm"]
    assert [n.flops for n in mm] == [2 * 4 * 8 * 2] * 2 and all(n.product for n in mm)
    assert mm[0].bytes == (32 + 16 + 8) * 2
    view = next(n for n in g.nodes if n.primitive in ("t", "transpose"))
    assert view.bytes == 0 and view.flops == 0 and view.backend == sdfg.HBM
    assert any(n.backend == sdfg.HOST for n in g.nodes)
    total = next(n for n in g.nodes if n.primitive == "sum")
    assert total.flops == 32 and total.backend == sdfg.CUDA_CORE
    clone = next(n for n in g.nodes if n.primitive == "clone")
    assert clone.bytes == (3 + 15) * 4
    regs = g.regions()
    assert regs["blk"].match() == sdfg.HOST and "<toplevel>" in regs
    assert g.edges and "digraph sdfg" in g.to_dot()
    summary = g.summary()
    assert set(summary) == set(sdfg.COMPONENTS)
    assert summary[sdfg.TENSOR_CORE]["flops"] == 128


def test_region_match_against_the_h100_balance():
    chip = specs.default_chip()
    assert chip.machine_balance == pytest.approx(989e12 / 3.35e12)
    assert round(chip.machine_balance) == 295
    r = sdfg.Region("r", flops=300.0 * 1000, bytes=1000.0)
    r.backends[sdfg.TENSOR_CORE] = 300.0 * 1000
    assert r.match(chip) == sdfg.TENSOR_CORE
    r2 = sdfg.Region("r2", flops=200.0 * 1000, bytes=1000.0)
    r2.backends[sdfg.TENSOR_CORE] = 200.0 * 1000
    assert r2.match(chip) == sdfg.HBM  # product-heavy but under the balance
    r3 = sdfg.Region("r3", flops=10.0, bytes=1000.0)
    assert r3.match(chip) == sdfg.HBM
    r4 = sdfg.Region("r4", flops=5000.0, bytes=1000.0)
    assert r4.match(chip) == sdfg.CUDA_CORE


def test_h100_spec_is_the_data_sheet():
    chip = specs.default_chip()
    assert (chip.name, chip.peak_flops_bf16, chip.peak_flops_f32, chip.hbm_bw) == (
        "h100_sxm", 989e12, 67e12, 3.35e12)
    assert (chip.hbm_bytes, chip.smem_bytes, chip.sm_count) == (80 * 10**9, 228 * 1024, 132)
    assert chip.link_total_bw == 450e9 and chip.host_bw == 64e9
    assert chip is specs.H100_SXM


def test_analyze_step_terms():
    cfg = reduced(get_config("qwen2-0.5b"))
    p = lm.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    rec = roofline.analyze_step(lambda t: lm.prefill(p, cfg, t)[0], toks)
    chip = specs.default_chip()
    assert rec["t_memory_s"] == rec["bytes"] / chip.hbm_bw
    assert rec["step_time_bound_s"] == max(rec["t_compute_s"], rec["t_memory_s"])
    assert rec["bottleneck"] in ("compute", "memory") and rec["kernel_nodes"] == 0
    # f32 on the CPU: no tensor-core work, every FLOP at the f32 rate
    assert rec["tensor_core_flops"] == 0
    assert rec["t_compute_s"] == pytest.approx(rec["flops"] / chip.peak_flops_f32)
    assert 0 < rec["product_flops"] <= rec["flops"]


def test_train_step_sdfg_sees_the_backward():
    """The dispatch mode records the backward's ops too: a train step's
    products are about three times the loss forward's."""
    from repro_torch.training import step as step_mod

    cfg = reduced(get_config("smollm-360m"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = step_mod.init_train_state(cfg, step_mod.TrainConfig(), 0, "cpu")
    fwd = sdfg.extract(lambda: lm.loss_fn(state["params"], cfg, batch["tokens"],
                                          batch["labels"])[0])
    step = sdfg.extract(step_mod.make_train_step(cfg, step_mod.TrainConfig()), state, batch)
    ratio = step.product_flops() / fwd.product_flops()
    assert 3.0 <= ratio < 3.5


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (16, 16, True, None, 0), (16, 16, False, None, 0), (40, 100, True, None, 60),
    (33, 33, True, 8, 0), (7, 50, True, 20, 43), (1, 1, True, None, 0)])
def test_attention_pair_count_matches_the_mask(Sq, Sk, causal, window, q_offset):
    """The (query, key) pairs the K1 / K1b notes count are the plain
    version's mask's ones."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    assert ops._pairs(Sq, Sk, causal, window, q_offset) == int(mask.sum())


def test_kernel_notes_only_on_the_card():
    """On the CPU an ops entry runs the plain version, which the record sees
    op by op: no kernel node.  A noted kernel reads its inputs and writes
    its outputs once."""
    q = torch.randn(1, 8, 2, 16)
    g = sdfg.extract(lambda: ops.attention(q, q, q))
    assert not any(n.kernel for n in g.nodes) and g.product_flops() == 2 * 2 * 8 * 8 * 16 * 2
    rec = sdfg.Recorder()
    x = torch.ones(4, 8, dtype=torch.bfloat16)
    rec.kernel("moe_gmm", (x, x), (x,), 100.0, product=True)
    rec.kernel("rmsnorm", (x.float(),), (x,), 32.0, product=False)
    n0, n1 = rec.nodes
    assert (n0.backend, n0.bytes, n0.kernel, n0.product) == (sdfg.TENSOR_CORE, 192.0, True, True)
    assert (n1.backend, n1.bytes) == (sdfg.CUDA_CORE, 128.0 + 64.0)
    assert sdfg.ACTIVE is None
