"""The port's model modules against the JAX package on reduced configs.

Both sides run the same weights: ``repro.models.lm.init_params`` converted
through ``repro_torch.models.convert.params_from_jax``.  Inputs come from
numpy seeds.  Logits agree within atol = rtol = 1e-4 in f32: XLA:CPU and
torch sum the matmuls in different orders.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.nn import attention as jax_attn  # noqa: E402
from repro.nn import core as jax_nn  # noqa: E402
from repro.nn import ffn as jax_ffn  # noqa: E402
from repro.nn import frontend as jax_frontend  # noqa: E402
from repro.nn import mamba as jax_mamba  # noqa: E402
from repro.nn import rwkv as jax_rwkv  # noqa: E402
from repro_torch.configs import base as configs_base  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import core as nn  # noqa: E402
from repro_torch.nn import ffn  # noqa: E402
from repro_torch.nn import frontend  # noqa: E402
from repro_torch.nn import mamba  # noqa: E402
from repro_torch.nn import rwkv  # noqa: E402

ARCHS = ["qwen2-0.5b", "smollm-360m", "deepseek-moe-16b", "dbrx-132b", "rwkv6-7b",
         "jamba-1.5-large", "gemma2-27b", "gemma3-4b", "chameleon-34b", "musicgen-large"]
# the archs with a frontend stub (precomputed embeddings added to the tokens')
FRONTEND_ARCHS = ["chameleon-34b", "musicgen-large"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), **(tol or TOL))


def _both(arch, **changes):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tree_close(jtree, ttree, **tol):
    assert set(jtree) == set(ttree)
    for k in jtree:
        if isinstance(jtree[k], dict):
            _tree_close(jtree[k], ttree[k], **tol)
        else:
            _close(jtree[k], ttree[k], **tol)


# ---------------------------------------------------------------------------
# configs, init and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_jax(arch):
    """Every field the port's config holds has the JAX config's value, at
    full width and reduced, and the default of every other field is
    what the port assumes."""
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))):
        fields = dataclasses.asdict(port)
        assert fields == {k: v for k, v in dataclasses.asdict(ref).items() if k in fields}
        assert ref.fused_attention_vjp is False
        assert (port.n_periods, port.period) == (ref.n_periods, ref.period)
        # the Mamba and RWKV sub-configs: the same fields and values, or
        # absent on both
        for sub in ("mamba", "rwkv"):
            assert (getattr(port, sub) is None) == (getattr(ref, sub) is None), sub
            if getattr(port, sub) is not None:
                assert dataclasses.asdict(getattr(port, sub)) == \
                    dataclasses.asdict(getattr(ref, sub)), sub


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's own init has the JAX tree's keys, shapes and dtypes, and
    its laws: zero biases and norm scales, std 0.02 weights, std dim**-0.5
    embeddings."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    jshapes = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k), jax.random.PRNGKey(0))
    p = lm.init_params(cfg, 0, device="cpu")

    def walk(j, t, path=""):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], f"{path}/{k}")
            else:
                assert tuple(t[k].shape) == j[k].shape, f"{path}/{k}"
                assert str(t[k].dtype).removeprefix("torch.") == str(j[k].dtype), f"{path}/{k}"

    walk(jshapes, p)
    assert float(p["final_norm"]["scale"].abs().max()) == 0.0
    ffn_p = p["blocks"]["pos0"]["ffn"]
    w = ffn_p["w1"] if "w1" in ffn_p else ffn_p["wk"]  # dense / MoE, or RWKV channel mix
    w = w["w"] if isinstance(w, dict) else w  # an MoE layer's experts are a bare leaf
    assert abs(float(w.std()) - 0.02) < 0.002
    assert abs(float(p["embed"]["table"].std()) - cfg.d_model**-0.5) < 0.01
    # seeded: the same seed draws the same weights
    again = lm.init_params(cfg, 0, device="cpu")
    torch.testing.assert_close(again["embed"]["table"], p["embed"]["table"])


def test_bridge_bf16_leaves_bit_exact():
    """bf16 leaves (ml_dtypes arrays) cross through a uint16 view, bit for bit."""
    jcfg, cfg, jp, p = _both("qwen2-0.5b", param_dtype="bfloat16", activation_dtype="bfloat16")
    jw = np.asarray(jp["blocks"]["pos0"]["mixer"]["q"]["w"])
    tw = p["blocks"]["pos0"]["mixer"]["q"]["w"]
    assert tw.dtype == torch.bfloat16 and tuple(tw.shape) == jw.shape
    assert tw.shape[0] == cfg.n_periods
    np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(np.uint16),
                                  jw.view(np.uint16))
    assert p["final_norm"]["scale"].dtype == torch.float32
    # and the bf16 model serves: prefill logits agree at bf16 tolerance
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    jl, _ = jax_lm.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), max_seq=16)
    tl, _ = lm.prefill(p, cfg, torch.from_numpy(toks), max_seq=16)
    _close(jl, tl, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_bridge_moe_expert_leaves_bit_exact(arch):
    """Stacked expert leaves (n_periods, E, D, F) cross bit for bit in bf16,
    beside the router, the shared experts and the dense head layer."""
    jcfg, cfg, jp, p = _both(arch, param_dtype="bfloat16", activation_dtype="bfloat16")
    jffn, tffn = jp["blocks"]["pos0"]["ffn"], p["blocks"]["pos0"]["ffn"]
    m = cfg.moe
    assert tuple(tffn["w1"].shape) == (cfg.n_periods, m.n_experts, cfg.d_model, m.d_expert)
    assert tuple(tffn["w2"].shape) == (cfg.n_periods, m.n_experts, m.d_expert, cfg.d_model)
    leaves = [(jffn[k], tffn[k]) for k in ("w1", "w3", "w2")]
    leaves.append((jffn["router"]["w"], tffn["router"]["w"]))
    if m.n_shared:
        leaves.append((jffn["shared"]["w1"]["w"], tffn["shared"]["w1"]["w"]))
    if cfg.first_k_dense:
        leaves.append((jp["head0"]["ffn"]["w1"]["w"], p["head0"]["ffn"]["w1"]["w"]))
    for jw, tw in leaves:
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jw).view(np.uint16))


def test_bridge_rejects_unstacked_block_leaves():
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="n_periods"):
        params_from_jax({"blocks": {"pos0": {"norm1": {"scale": np.zeros(64, np.float32)}}}}, cfg,
                        device="cpu")


# ---------------------------------------------------------------------------
# nn/core pieces
# ---------------------------------------------------------------------------


def test_linear_contracts_last_dims_with_bias():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 8), np.float32)
    w = rng.standard_normal((8, 3, 4), np.float32)
    b = rng.standard_normal((3, 4), np.float32)
    _close(jax_nn.linear({"w": w, "b": b}, jnp.asarray(x)), nn.linear({"w": _t(w), "b": _t(b)}, _t(x)))
    w2 = rng.standard_normal((3, 4, 6), np.float32)
    y = rng.standard_normal((2, 5, 3, 4), np.float32)
    _close(jax_nn.linear({"w": w2}, jnp.asarray(y), n_in=2), nn.linear({"w": _t(w2)}, _t(y), n_in=2))
    xb = nn.linear({"w": _t(w).bfloat16()}, _t(x).bfloat16())
    assert xb.dtype == torch.bfloat16  # output in x's dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_one_plus_scale(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 64), np.float32)
    s = rng.standard_normal(64, np.float32) * 0.1
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_nn.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x, jd))
    got = nn.rmsnorm({"scale": _t(s)}, _t(x).to(td))
    assert got.dtype == td
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    _close(want, got, **tol)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_split_half(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 16), np.float32)
    pos = rng.integers(0, 1000, (2, 9)).astype(np.int32)
    _close(jax_nn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           nn.apply_rope(_t(x), _t(pos), theta))


@pytest.mark.parametrize("scale_by_dim", [False, True])
def test_embed(scale_by_dim):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 24), np.float32)
    ids = rng.integers(0, 50, (3, 6))
    _close(jax_nn.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), scale_by_dim=scale_by_dim),
           nn.embed({"table": _t(table)}, _t(ids), scale_by_dim=scale_by_dim))


def test_unembed_returns_f32_from_bf16():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 64), np.float32)
    h = rng.standard_normal((4, 64), np.float32)
    want = jax_nn.unembed({"table": jnp.asarray(table, jnp.bfloat16)}, jnp.asarray(h, jnp.bfloat16))
    tt = _t(table).bfloat16()
    got = nn.unembed({"table": tt}, _t(h).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(want, got, atol=1e-4, rtol=1e-5)
    # what a bf16 product would lose: its output rounded to bf16
    rounded = torch.matmul(_t(h).bfloat16(), tt.t()).float()
    assert float((rounded - got).abs().max()) > 1e-3


def test_activations_and_softcap():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    for name in ("silu", "gelu", "relu"):
        _close(jax_nn.ACTIVATIONS[name](jnp.asarray(x)), nn.ACTIVATIONS[name](_t(x)))
    _close(jax_nn.softcap(jnp.asarray(x), 3.0), nn.softcap(_t(x), 3.0))
    tx = _t(x)
    assert nn.softcap(tx, None) is tx


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixer,S,window", [("ga", 10, 16), ("swa", 10, 4)])
def test_attention_apply_full_and_decode(mixer, S, window):
    """Prefill fills the cache (a ring smaller than the prompt for swa),
    then three decode steps write slot pos % size and attend."""
    jcfg, cfg, _, _ = _both("qwen2-0.5b", sliding_window=window)
    jp = jax_attn.attention_init(jax_nn.ValueFactory(jax.random.PRNGKey(1), jnp.float32), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(6)
    B, max_seq = 2, 16
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    jc = jax_attn.init_cache(jcfg, mixer, B, max_seq, jnp.float32)
    tc = attn.init_cache(cfg, mixer, B, max_seq, torch.float32, torch.device("cpu"))
    jo, jc = jax_attn.attention_apply(jp, jnp.asarray(x), jcfg, mixer, jnp.asarray(pos),
                                      mode="full", cache=jc)
    to, tc = attn.attention_apply(p, _t(x), cfg, mixer, _t(pos), mode="full", cache=tc)
    _close(jo, to)
    _tree_close(jc, tc)
    for t in range(S, S + 3):
        xt = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        pt = np.full((B, 1), t, np.int32)
        jo, jc = jax_attn.attention_apply(jp, jnp.asarray(xt), jcfg, mixer, jnp.asarray(pt),
                                          mode="decode", cache=jc)
        to, tc = attn.attention_apply(p, _t(xt), cfg, mixer, _t(pt), mode="decode", cache=tc)
        _close(jo, to)
        _tree_close(jc, tc)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jp, p = _both(arch)
    B, S, max_seq = 2, 8, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 4))
    jl, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), max_seq=max_seq)
    tl, tc = lm.prefill(p, cfg, _t(toks[:, :S]), max_seq=max_seq)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, cfg.vocab_size)
    _close(jl, tl)
    _tree_close(jc, tc)
    for t in range(S, S + 4):
        cur = np.full((B,), t, np.int32)
        jl, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                                    jnp.asarray(cur), jc)
        tl, tc = lm.decode_step(p, cfg, _t(toks[:, t]), _t(cur), tc)
        _close(jl, tl)
    _tree_close(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Teacher-forced decode reproduces the full-sequence logits in the port.

    An MoE layer's capacity is per group of tokens by design: a 24-token
    forward may drop picks that a 2-token decode step keeps.  The property
    held here is the cache's, so MoE configs get a capacity with no drops
    (test_moe_apply_matches_jax holds the drops themselves)."""
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = lm.init_params(cfg, 0, device="cpu")
    B, S = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S)))
    hidden, _ = lm.forward(params, cfg, tokens)
    full = lm._logits(params, cfg, hidden)
    half = S // 2
    _, caches = lm.prefill(params, cfg, tokens[:, :half], max_seq=S)
    got = []
    for t in range(half, S):
        logits, caches = lm.decode_step(params, cfg, tokens[:, t],
                                        torch.full((B,), t, dtype=torch.int32), caches)
        got.append(logits)
    torch.testing.assert_close(torch.stack(got, 1), full[:, half:], atol=2e-5, rtol=2e-5)


def test_gemma3_tail_and_wrapped_ring_match_jax():
    """Reduced gemma3-4b at 10 layers, one period of (swa x 5, ga) and a tail
    of 4 swa layers as at full depth (5 periods + 4): the tree (``tail6`` ..
    ``tail9`` unscanned, the post-block norms, one tied table), then a
    20-token prompt, longer than the window of 16, so each local layer's
    16-slot ring keeps the prompt's last 16 positions, and six decode steps
    that wrap it again; logits and caches against the JAX model in f32
    (TOL)."""
    jcfg, cfg, jp, p = _both("gemma3-4b", n_layers=10)
    assert (cfg.n_periods, [n for n, _ in lm._unscanned_layers(cfg)]) == \
        (1, ["tail6", "tail7", "tail8", "tail9"])
    assert "lm_head" not in p and {"norm1_post", "norm2_post"} <= set(p["tail9"])
    _tree_close(jax.tree.map(np.asarray, jp), p)
    B, S, max_seq = 2, 20, 32
    toks = np.random.default_rng(23).integers(0, cfg.vocab_size, (B, S + 6))
    jl, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), max_seq=max_seq)
    tl, tc = lm.prefill(p, cfg, _t(toks[:, :S]), max_seq=max_seq)
    ring = tc["tail9"]["mixer"]["pos_ids"]
    assert ring.shape == (B, cfg.sliding_window) and int(ring.min()) == S - cfg.sliding_window
    _close(jl, tl)
    _tree_close(jc, tc)
    for t in range(S, S + 6):
        cur = np.full((B,), t, np.int32)
        jl, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                                    jnp.asarray(cur), jc)
        tl, tc = lm.decode_step(p, cfg, _t(toks[:, t]), _t(cur), tc)
        _close(jl, tl)
    _tree_close(jc, tc)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
@pytest.mark.parametrize("capacity_factor,group_size", [(1.25, None), (0.5, None), (1.25, 8)])
def test_moe_apply_matches_jax(arch, capacity_factor, group_size):
    """y and both aux losses against repro.nn.ffn.moe_apply on the same
    weights and input: routing, capacity drops in priority (choice rank,
    token position), gates, shared experts.  capacity_factor 0.5 leaves
    slots for half the picks; group_size 8 routes in 16 groups."""
    jcfg, cfg, _, _ = _both(arch)
    m = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=m)
    jp = jax_ffn.moe_init(jax_nn.ValueFactory(jax.random.PRNGKey(2), jnp.float32), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 64, cfg.d_model), np.float32)
    jy, jaux = jax_ffn.moe_apply(jp, jnp.asarray(x), jcfg, group_size=group_size)
    y, aux = ffn.moe_apply(p, _t(x), cfg, group_size=group_size)
    assert y.dtype == torch.float32 and y.shape == (2, 64, cfg.d_model)
    _close(jy, y)
    for name in ("moe_load_balance", "moe_z_loss"):
        _close(jaux[name], aux[name], atol=1e-6, rtol=1e-5)
    G = group_size or 128
    C = ffn._capacity(G, m)
    assert C == jax_ffn._capacity(G, jcfg.moe)
    if capacity_factor < 1:  # the case holds drops: fewer slots than picks
        assert (128 // G) * m.n_experts * C < 128 * m.top_k


def test_moe_apply_bf16_routes_on_the_rounded_router():
    """In bf16 the router product is rounded to bf16 before the f32
    softmax, as in the JAX package: the same picks, and y within bf16."""
    jcfg, cfg, _, _ = _both("deepseek-moe-16b", param_dtype="bfloat16",
                            activation_dtype="bfloat16")
    jp = jax_ffn.moe_init(jax_nn.ValueFactory(jax.random.PRNGKey(3), jnp.bfloat16), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    x = np.random.default_rng(10).standard_normal((1, 24, cfg.d_model), np.float32)
    jy, jaux = jax_ffn.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, aux = ffn.moe_apply(p, _t(x).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16
    _close(jy, y, atol=2e-2, rtol=2e-2)
    _close(jaux["moe_z_loss"], aux["moe_z_loss"], atol=1e-6, rtol=1e-5)


def test_moe_capacity_and_group_size_copies():
    m = reduced(get_config("deepseek-moe-16b")).moe
    full = get_config("deepseek-moe-16b").moe
    for G in (1, 8, 16, 512, 2048):
        jm = jax_reduced(jax_get_config("deepseek-moe-16b")).moe
        assert ffn._capacity(G, m) == jax_ffn._capacity(G, jm)
    assert (ffn._capacity(512, full), ffn._capacity(8, full)) == (64, 8)  # serving: prefill, decode
    for n in (1, 7, 512, 4096, 6000):
        assert ffn.pick_group_size(n) == jax_ffn.pick_group_size(n)


def test_unported_layers_raise():
    """A text arch given a frontend stub builds the JAX tree, ``frontend/proj``
    included (every layer kind of the JAX package is ported now), and an
    unknown FFN kind raises as the JAX model's does."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), frontend="vlm_stub")
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")), frontend="vlm_stub")
    jshapes = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k), jax.random.PRNGKey(0))
    p = lm.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jshapes) == _map_shapes(p)
    assert tuple(p["frontend"]["proj"]["w"].shape) == (cfg.d_model, cfg.d_model)
    assert "b" not in p["frontend"]["proj"]
    bad = dataclasses.replace(cfg, layer_pattern=(configs_base.LayerSpec("ga", "glu"),))
    with pytest.raises(ValueError, match="glu"):
        lm.init_params(bad, 0, device="cpu")


def _map_shapes(tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# the RWKV6 layers
# ---------------------------------------------------------------------------

# Leaves the JAX init sets to zeros or ones.  At init they make the ddlerp
# return x for every target and the decay constant in time, so the parity
# tests below overwrite them with seeded noise on both sides.
_RWKV_FLAT_LEAVES = {"mu_base": 0.5, "mu": 0.5, "mix_w2": 0.3, "decay_w2": 0.5, "mu_k": 0.5,
                     "mu_r": 0.5, "ln_scale": 0.3, "ln_bias": 0.3}


def _perturb_rwkv(tree, seed):
    """A copy of a JAX param tree (numpy leaves) with every flat-init RWKV
    leaf replaced by noise (ln_scale around 1)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _RWKV_FLAT_LEAVES:
                noise = rng.standard_normal(v.shape) * _RWKV_FLAT_LEAVES[k]
                out[k] = (noise + (k == "ln_scale")).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(jax.tree.map(np.asarray, tree))


def _rwkv_layer(init_name, seed):
    jcfg, cfg, _, _ = _both("rwkv6-7b")
    jp = getattr(jax_rwkv, init_name)(jax_nn.ValueFactory(jax.random.PRNGKey(seed), jnp.float32),
                                      jcfg)
    jp = _perturb_rwkv(jp, seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), params_from_jax(jp, cfg, device="cpu")


def test_rwkv_init_laws():
    """The port's own init: the decay base in every period, ones and zeros
    where the JAX init puts them, f32 for w0 and the group-norm affine."""
    cfg = reduced(get_config("rwkv6-7b"))
    p = lm.init_params(cfg, 0, device="cpu")["blocks"]["pos0"]
    tm, cm = p["mixer"], p["ffn"]
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    base = -6.0 + 5.0 * (np.arange(K, dtype=np.float32) / (K - 1)) ** 0.7
    for leaf in ("w0", "ln_scale", "ln_bias"):
        assert tm[leaf].dtype == torch.float32 and tuple(tm[leaf].shape) == (cfg.n_periods, H, K)
    np.testing.assert_allclose(tm["w0"].numpy(), np.broadcast_to(base, (cfg.n_periods, H, K)),
                               rtol=1e-6)
    assert bool((tm["ln_scale"] == 1).all()) and bool((tm["ln_bias"] == 0).all())
    for leaf in ("mu_base", "mu", "mix_w2", "decay_w2"):
        assert bool((tm[leaf] == 0).all()), leaf
    assert bool((cm["mu_k"] == 0).all()) and bool((cm["mu_r"] == 0).all())
    assert abs(float(tm["u"].std()) - 0.5) < 0.1


def test_bridge_rwkv_leaves_keep_their_dtypes():
    """In a bf16 model the f32 leaves (w0, ln_scale, ln_bias) cross as f32
    and the bf16 leaves bit for bit."""
    jcfg, cfg, jp, p = _both("rwkv6-7b", param_dtype="bfloat16", activation_dtype="bfloat16")
    jm, tm = jp["blocks"]["pos0"]["mixer"], p["blocks"]["pos0"]["mixer"]
    for leaf in ("w0", "ln_scale", "ln_bias"):
        assert tm[leaf].dtype == torch.float32
        np.testing.assert_array_equal(tm[leaf].numpy(), np.asarray(jm[leaf]))
    for jw, tw in ((jm["u"], tm["u"]), (jm["mix_w1"], tm["mix_w1"]),
                   (jm["recv"]["w"], tm["recv"]["w"]),
                   (jp["blocks"]["pos0"]["ffn"]["wk"]["w"], p["blocks"]["pos0"]["ffn"]["wk"]["w"])):
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jw).view(np.uint16))


@pytest.mark.parametrize("with_cache", [False, True])
def test_time_mix_apply_full_and_decode(with_cache):
    """repro.nn.rwkv.time_mix_apply with every flat-init leaf perturbed: a
    full sequence (no cache, or filling one), then three decode steps
    against the cache (shift and f32 WKV state compared each step)."""
    jcfg, cfg, jp, p = _rwkv_layer("time_mix_init", 11)
    rng = np.random.default_rng(12)
    B, S, D = 2, 16, cfg.d_model
    H, K = D // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    x = rng.standard_normal((B, S, D), np.float32)
    jc = jax_rwkv.init_time_cache(jcfg, B, jnp.float32) if with_cache else None
    tc = rwkv.init_time_cache(cfg, B, torch.float32, torch.device("cpu")) if with_cache else None
    jo, jc = jax_rwkv.time_mix_apply(jp, jnp.asarray(x), jcfg, mode="full", cache=jc)
    to, tc = rwkv.time_mix_apply(p, _t(x), cfg, mode="full", cache=tc)
    _close(jo, to)
    if not with_cache:
        assert tc is None
        return
    assert tuple(tc["wkv"].shape) == (B, H, K, K) and tc["wkv"].dtype == torch.float32
    _tree_close(jc, tc)
    for _ in range(3):
        xt = rng.standard_normal((B, 1, D), np.float32)
        jo, jc = jax_rwkv.time_mix_apply(jp, jnp.asarray(xt), jcfg, mode="decode", cache=jc)
        to, tc = rwkv.time_mix_apply(p, _t(xt), cfg, mode="decode", cache=tc)
        _close(jo, to)
        _tree_close(jc, tc)
    # the shift cache holds the last input of the sub-layer
    np.testing.assert_array_equal(tc["shift"].numpy(), xt[:, -1])


def test_channel_mix_apply_full_and_decode():
    jcfg, cfg, jp, p = _rwkv_layer("channel_mix_init", 13)
    rng = np.random.default_rng(14)
    B, S, D = 2, 10, cfg.d_model
    x = rng.standard_normal((B, S, D), np.float32)
    jc = jax_rwkv.init_channel_cache(jcfg, B, jnp.float32)
    tc = rwkv.init_channel_cache(cfg, B, torch.float32, torch.device("cpu"))
    jo, jc = jax_rwkv.channel_mix_apply(jp, jnp.asarray(x), jcfg, cache=jc)
    to, tc = rwkv.channel_mix_apply(p, _t(x), cfg, cache=tc)
    _close(jo, to)
    _tree_close(jc, tc)
    for _ in range(3):
        xt = rng.standard_normal((B, 1, D), np.float32)
        jo, jc = jax_rwkv.channel_mix_apply(jp, jnp.asarray(xt), jcfg, cache=jc)
        to, tc = rwkv.channel_mix_apply(p, _t(xt), cfg, cache=tc)
        _close(jo, to)
        _tree_close(jc, tc)
    jo, _ = jax_rwkv.channel_mix_apply(jp, jnp.asarray(x), jcfg)
    to, none = rwkv.channel_mix_apply(p, _t(x), cfg)
    assert none is None
    _close(jo, to)


def test_rwkv_model_with_perturbed_leaves_matches_jax():
    """Reduced rwkv6-7b with every flat-init leaf perturbed, so the
    data-dependent mix and decay act: prefill, caches and four decode steps
    against the JAX model."""
    jcfg, cfg, jp, _ = _both("rwkv6-7b")
    noisy = _perturb_rwkv(jp, 15)
    jp, p = jax.tree.map(jnp.asarray, noisy), params_from_jax(noisy, cfg, device="cpu")
    B, S = 2, 16
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (B, S + 4))
    jl, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), max_seq=32)
    tl, tc = lm.prefill(p, cfg, _t(toks[:, :S]), max_seq=32)
    _close(jl, tl)
    _tree_close(jc, tc)
    for t in range(S, S + 4):
        cur = np.full((B,), t, np.int32)
        jl, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                                    jnp.asarray(cur), jc)
        tl, tc = lm.decode_step(p, cfg, _t(toks[:, t]), _t(cur), tc)
        _close(jl, tl)
    _tree_close(jc, tc)


@pytest.mark.parametrize("S", [12, 16, 20, 32])
def test_rwkv_prefill_chunk_contract(S):
    """A prompt longer than the scan's chunk (16 reduced, 128 at full width)
    must be a multiple of it, in the JAX package and in the port alike
    (ROADMAP R6): 20 fails on both sides, 12, 16 and 32 pass on both."""
    jcfg, cfg, jp, p = _both("rwkv6-7b")
    toks = np.zeros((1, S), np.int64)
    if S % cfg.rwkv.chunk and S > cfg.rwkv.chunk:
        with pytest.raises(AssertionError, match="multiple of chunk"):
            jax_lm.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), max_seq=S)
        with pytest.raises(ValueError, match="multiple of chunk"):
            lm.prefill(p, cfg, _t(toks), max_seq=S)
    else:
        jl, _ = jax_lm.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), max_seq=S)
        tl, _ = lm.prefill(p, cfg, _t(toks), max_seq=S)
        _close(jl, tl)


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

# Leaves the JAX init sets flat (the same A_log row for every channel, D all
# ones, zero conv bias and norm scales), with the std of the seeded noise
# the tests below add to them on both sides.  At init a fault that indexes
# A or D with the wrong channel, or swaps channel tiles, changes nothing.
# A = -exp(A_log) stays negative, so every decay stays in (0, 1).
_MAMBA_FLAT_LEAVES = {"A_log": 0.5, "D": 0.5, "conv_b": 0.1, "scale": 0.3}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _perturb_mamba(tree, seed):
    """A copy of a JAX param tree (numpy leaves) with seeded noise added to
    every flat-init Mamba leaf (and to every norm scale)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _MAMBA_FLAT_LEAVES:
                out[k] = (v + rng.standard_normal(v.shape) * _MAMBA_FLAT_LEAVES[k]).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(jax.tree.map(np.asarray, tree))


def _mamba_layer(seed, dtype="float32"):
    jcfg, cfg, _, _ = _both("jamba-1.5-large", param_dtype=dtype, activation_dtype=dtype)
    vf = jax_nn.ValueFactory(jax.random.PRNGKey(seed), DTYPES[dtype][0])
    jp = _perturb_mamba(jax_mamba.mamba_init(vf, jcfg), seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), params_from_jax(jp, cfg, device="cpu")


def test_mamba_init_laws():
    """The port's own init: A_log = log(1..N) in every channel and period,
    D ones, zero conv bias and norm scales, softplus(dt_bias) in
    [1e-3, 1e-1], conv_w std 1/sqrt(d_conv), and f32 for A_log, dt_bias, D."""
    cfg = reduced(get_config("jamba-1.5-large"))
    m = lm.init_params(cfg, 0, device="cpu")["blocks"]["pos0"]["mixer"]
    DI, N, DC, R = mamba._dims(cfg)
    assert (DI, N, DC, R) == (128, 8, 4, 4)
    for leaf in ("A_log", "dt_bias", "D"):
        assert m[leaf].dtype == torch.float32, leaf
    np.testing.assert_allclose(m["A_log"].numpy(),
                               np.broadcast_to(np.log(np.arange(1, N + 1)), (1, DI, N)), rtol=1e-6)
    assert bool((m["D"] == 1).all()) and bool((m["conv_b"] == 0).all())
    for norm in ("dt_norm", "b_norm", "c_norm"):
        assert bool((m[norm]["scale"] == 0).all()), norm
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert float(dt.max()) / float(dt.min()) > 20  # log-uniform, not a constant
    assert abs(float(m["conv_w"].std()) - DC**-0.5) < 0.05


def test_bridge_mamba_leaves_keep_their_dtypes():
    """In a bf16 model the f32 leaves (A_log, dt_bias, D) cross as f32 and
    the bf16 leaves bit for bit."""
    jcfg, cfg, jp, p = _both("jamba-1.5-large", param_dtype="bfloat16",
                             activation_dtype="bfloat16")
    jm, tm = jp["blocks"]["pos0"]["mixer"], p["blocks"]["pos0"]["mixer"]
    for leaf in ("A_log", "dt_bias", "D"):
        assert tm[leaf].dtype == torch.float32
        np.testing.assert_array_equal(tm[leaf].numpy(), np.asarray(jm[leaf]))
    for jw, tw in ((jm["conv_w"], tm["conv_w"]),
                   *((jm[k]["w"], tm[k]["w"]) for k in ("in_proj", "x_proj", "dt_proj"))):
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jw).view(np.uint16))


@pytest.mark.parametrize("dtype,S,with_cache", [("float32", 16, False), ("float32", 16, True),
                                                ("float32", 2, True), ("bfloat16", 16, True)])
def test_mamba_apply_full_and_decode(dtype, S, with_cache):
    """repro.nn.mamba.mamba_apply with every flat-init leaf perturbed: a
    full sequence (no cache, or filling one; S = 2 is shorter than the conv
    window, so the cache keeps part of its old rows), then three decode
    steps against the cache (conv window and f32 SSM state compared each
    step).  bf16 at tests/test_kernels.py's 2e-2: XLA on the CPU and eager
    torch round the conv sum and the casts at different places."""
    jcfg, cfg, jp, p = _mamba_layer(17, dtype)
    jd, td = DTYPES[dtype]
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    rng = np.random.default_rng(18)
    B, D = 2, cfg.d_model
    DI, N, DC, _ = mamba._dims(cfg)
    x = rng.standard_normal((B, S, D), np.float32)
    jc = tc = None
    if with_cache:
        jc = jax_mamba.init_cache(jcfg, B, jd)
        tc = mamba.init_cache(cfg, B, td, torch.device("cpu"))
        old = rng.standard_normal((B, DC - 1, DI), np.float32)  # rows a short prompt keeps
        jc["conv"] = jnp.asarray(old, jd)
        tc["conv"].copy_(_t(old))
    jo, jc = jax_mamba.mamba_apply(jp, jnp.asarray(x, jd), jcfg, mode="full", cache=jc)
    to, tc = mamba.mamba_apply(p, _t(x).to(td), cfg, mode="full", cache=tc)
    assert to.dtype == td
    _close(jo, to, **tol)
    if not with_cache:
        assert tc is None
        return
    assert tuple(tc["ssm"].shape) == (B, DI, N) and tc["ssm"].dtype == torch.float32
    assert tuple(tc["conv"].shape) == (B, DC - 1, DI) and tc["conv"].dtype == td
    _tree_close(jc, tc, **tol)
    for _ in range(3):
        xt = rng.standard_normal((B, 1, D), np.float32)
        jo, jc = jax_mamba.mamba_apply(jp, jnp.asarray(xt, jd), jcfg, mode="decode", cache=jc)
        to, tc = mamba.mamba_apply(p, _t(xt).to(td), cfg, mode="decode", cache=tc)
        _close(jo, to, **tol)
        _tree_close(jc, tc, **tol)


def test_mamba_dt_matches_jax_above_softplus_threshold():
    """dt = softplus(dt_proj(dt_norm(...)) + dt_bias), B and C against
    repro.nn.mamba._ssm_inputs with dt_bias spread over [-40, 40]: dt from
    ~1e-18 to past 20, where the init's LogUniform dt_bias never reaches."""
    jcfg, cfg, jp, p = _mamba_layer(21)
    DI = mamba._dims(cfg)[0]
    bias = np.linspace(-40, 40, DI, dtype=np.float32)
    jp["dt_bias"], p["dt_bias"] = jnp.asarray(bias), _t(bias)
    xs = np.random.default_rng(22).standard_normal((2, 5, DI), np.float32)
    jdt, jb, jc = jax_mamba._ssm_inputs(jp, jnp.asarray(xs), jcfg)
    dt, b, c = mamba._ssm_inputs(p, _t(xs), cfg)
    assert dt.dtype == torch.float32 and float(dt.max()) > 20
    _close(jdt, dt, atol=1e-5, rtol=1e-6)
    _close(jb, b)
    _close(jc, c)


@pytest.mark.parametrize("n_layers", [8, 5])
def test_jamba_with_perturbed_leaves_matches_jax(n_layers):
    """Reduced jamba with every flat-init Mamba leaf perturbed: prefill,
    caches and four decode steps against the JAX model in f32.  8 layers is
    one whole period (stacked (1, B, ...) caches); 5 layers is the served
    cut's pattern, every layer a ``tail{i}`` leaf and no period."""
    jcfg, cfg, jp, _ = _both("jamba-1.5-large", n_layers=n_layers)
    assert cfg.n_periods == (1 if n_layers == 8 else 0)
    noisy = _perturb_mamba(jp, 19)
    jp, p = jax.tree.map(jnp.asarray, noisy), params_from_jax(noisy, cfg, device="cpu")
    B, S = 2, 16
    toks = np.random.default_rng(20).integers(0, cfg.vocab_size, (B, S + 4))
    jl, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), max_seq=32)
    tl, tc = lm.prefill(p, cfg, _t(toks[:, :S]), max_seq=32)
    _close(jl, tl)
    _tree_close(jc, tc)
    for t in range(S, S + 4):
        cur = np.full((B,), t, np.int32)
        jl, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                                    jnp.asarray(cur), jc)
        tl, tc = lm.decode_step(p, cfg, _t(toks[:, t]), _t(cur), tc)
        _close(jl, tl)
    _tree_close(jc, tc)


@pytest.mark.parametrize("S", [12, 16, 20, 32])
def test_mamba_prefill_chunk_contract(S):
    """A prompt longer than the scan's chunk (16 reduced, 256 at full width)
    must be a multiple of it, in the JAX package and in the port alike
    (ROADMAP R8): 20 fails on both sides, 12, 16 and 32 pass on both."""
    jcfg, cfg, jp, p = _both("jamba-1.5-large")
    toks = np.zeros((1, S), np.int64)
    if S % cfg.mamba.chunk and S > cfg.mamba.chunk:
        with pytest.raises(AssertionError, match="multiple of chunk"):
            jax_lm.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), max_seq=S)
        with pytest.raises(ValueError, match="multiple of chunk"):
            lm.prefill(p, cfg, _t(toks), max_seq=S)
    else:
        jl, _ = jax_lm.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), max_seq=S)
        tl, _ = lm.prefill(p, cfg, _t(toks), max_seq=S)
        _close(jl, tl)


# ---------------------------------------------------------------------------
# the frontend stubs and QK-norm (chameleon-34b, musicgen-large)
# ---------------------------------------------------------------------------


def _perturb_scales(tree, seed):
    """A copy of a JAX param tree (numpy leaves) whose RMSNorm scales are
    N(0, 0.5): at init they are zeros, so a norm that dropped its scale, or
    took another norm's, would match."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * 0.5).astype(v.dtype) if k == "scale" else v
                for k, v in t.items()}

    return walk(jax.tree.map(np.asarray, tree))


def _both_perturbed(arch, seed=0, **changes):
    jcfg, cfg, jp, _ = _both(arch, **changes)
    np_p = _perturb_scales(jp, seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, np_p), params_from_jax(np_p, cfg, device="cpu")


def test_frontend_apply_matches_jax():
    """The stub alone: a (d, d) projection without bias, std 0.02."""
    jcfg, cfg, _, _ = _both("musicgen-large")
    jp = jax_frontend.frontend_init(jax_nn.ValueFactory(jax.random.PRNGKey(3), jnp.float32), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    emb = np.random.default_rng(40).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(jax_frontend.frontend_apply(jp, jnp.asarray(emb)), frontend.frontend_apply(p, _t(emb)))
    own = frontend.frontend_init(nn.ParamFactory(torch.Generator().manual_seed(0), torch.float32,
                                                 torch.device("cpu")), cfg)
    assert set(own) == {"proj"} and set(own["proj"]) == {"w"}
    assert tuple(own["proj"]["w"].shape) == (cfg.d_model, cfg.d_model)
    assert abs(float(own["proj"]["w"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("mixer,S,window", [("ga", 10, 16), ("swa", 10, 4)])
def test_qk_norm_attention_apply_full_and_decode(mixer, S, window):
    """QK-norm alone: chameleon's attention block (q_norm and k_norm over
    head_dim, after the projections, before RoPE) with its scales
    perturbed, prefill then three decode steps, against the JAX block."""
    jcfg, cfg, _, _ = _both("chameleon-34b", sliding_window=window)
    assert cfg.qk_norm
    jp = jax_attn.attention_init(jax_nn.ValueFactory(jax.random.PRNGKey(2), jnp.float32), jcfg)
    np_p = _perturb_scales(jp, 41)
    jp, p = jax.tree.map(jnp.asarray, np_p), params_from_jax(np_p, cfg, device="cpu")
    assert tuple(p["q_norm"]["scale"].shape) == (cfg.head_dim,) == tuple(p["k_norm"]["scale"].shape)
    rng = np.random.default_rng(42)
    B, max_seq = 2, 16
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    jc = jax_attn.init_cache(jcfg, mixer, B, max_seq, jnp.float32)
    tc = attn.init_cache(cfg, mixer, B, max_seq, torch.float32, torch.device("cpu"))
    jo, jc = jax_attn.attention_apply(jp, jnp.asarray(x), jcfg, mixer, jnp.asarray(pos),
                                      mode="full", cache=jc)
    to, tc = attn.attention_apply(p, _t(x), cfg, mixer, _t(pos), mode="full", cache=tc)
    _close(jo, to)
    _tree_close(jc, tc)
    # the norms act: without them the block's output moves
    plain = dataclasses.replace(cfg, qk_norm=False)
    bare, _ = attn.attention_apply(p, _t(x), plain, mixer, _t(pos), mode="full")
    assert float((bare - to).abs().max()) > 1e-2
    for t in range(S, S + 3):
        xt = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        pt = np.full((B, 1), t, np.int32)
        jo, jc = jax_attn.attention_apply(jp, jnp.asarray(xt), jcfg, mixer, jnp.asarray(pt),
                                          mode="decode", cache=jc)
        to, tc = attn.attention_apply(p, _t(xt), cfg, mixer, _t(pt), mode="decode", cache=tc)
        _close(jo, to)
        _tree_close(jc, tc)


def test_qk_norm_sends_rows_of_head_dim_to_the_norm(monkeypatch):
    """The RMSNorm op gets q and k as contiguous (..., head_dim) tensors:
    on the card K3 reads them as rows of head_dim."""
    _, cfg, _, p = _both("chameleon-34b")
    seen = []
    real = nn.ops.rmsnorm

    def spy(x, scale, **kw):
        seen.append((tuple(x.shape), x.is_contiguous(), tuple(scale.shape)))
        return real(x, scale, **kw)

    monkeypatch.setattr(nn.ops, "rmsnorm", spy)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    attn.attention_apply(_map_period0(p["blocks"]["pos0"]["mixer"]), x, cfg, "ga", pos)
    hd = cfg.head_dim
    assert seen == [((2, 5, cfg.n_heads, hd), True, (hd,)),
                    ((2, 5, cfg.n_kv_heads, hd), True, (hd,))]


def _map_period0(tree):
    if isinstance(tree, dict):
        return {k: _map_period0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_forward_with_frontend_matches_jax(arch):
    """The full forward's hidden states with frontend embeddings (norm
    scales perturbed), against the JAX forward; the embeddings change them."""
    jcfg, cfg, jp, p = _both_perturbed(arch, 43)
    rng = np.random.default_rng(44)
    B, S = 2, 9
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    fe = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jh, _, _ = jax_lm.forward(jp, jcfg, jnp.asarray(toks, jnp.int32), frontend_embed=jnp.asarray(fe))
    th, _ = lm.forward(p, cfg, _t(toks), frontend_embed=_t(fe))
    _close(jh, th)
    without, _ = lm.forward(p, cfg, _t(toks))
    assert float((without - th).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_and_decode_with_frontend_match_jax(arch):
    """Prefill with (B, S, d) embeddings, then four decode steps each with
    its (B, 1, d) slice, as tests/test_arch_smoke.py feeds them: logits and
    caches against the JAX model."""
    jcfg, cfg, jp, p = _both_perturbed(arch, 45)
    rng = np.random.default_rng(46)
    B, S, max_seq = 2, 8, 16
    toks = rng.integers(0, cfg.vocab_size, (B, S + 4))
    fe = rng.standard_normal((B, S + 4, cfg.d_model)).astype(np.float32)
    jl, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                            jnp.asarray(fe[:, :S]), max_seq=max_seq)
    tl, tc = lm.prefill(p, cfg, _t(toks[:, :S]), _t(fe[:, :S]), max_seq=max_seq)
    _close(jl, tl)
    _tree_close(jc, tc)
    for t in range(S, S + 4):
        cur = np.full((B,), t, np.int32)
        jl, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                                    jnp.asarray(cur), jc, jnp.asarray(fe[:, t:t + 1]))
        tl, tc = lm.decode_step(p, cfg, _t(toks[:, t]), _t(cur), tc, _t(fe[:, t:t + 1]))
        _close(jl, tl)
    _tree_close(jc, tc)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_decode_with_frontend_matches_full_forward(arch):
    """Teacher-forced decode with each step's embedding slice reproduces the
    full forward's logits with the whole embedding stream."""
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(47)
    B, S = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    fe = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    hidden, _ = lm.forward(params, cfg, tokens, frontend_embed=fe)
    full = lm._logits(params, cfg, hidden)
    half = S // 2
    _, caches = lm.prefill(params, cfg, tokens[:, :half], fe[:, :half], max_seq=S)
    got = []
    for t in range(half, S):
        logits, caches = lm.decode_step(params, cfg, tokens[:, t],
                                        torch.full((B,), t, dtype=torch.int32), caches,
                                        fe[:, t:t + 1])
        got.append(logits)
    torch.testing.assert_close(torch.stack(got, 1), full[:, half:], atol=2e-5, rtol=2e-5)


def test_text_arch_ignores_frontend_embed():
    """As in the JAX forward, an arch without a frontend ignores embeddings."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(48).integers(0, cfg.vocab_size, (2, 6)))
    fe = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(lm.forward(params, cfg, toks, frontend_embed=fe)[0],
                               lm.forward(params, cfg, toks)[0], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_bridge_frontend_and_qk_norm_leaves(arch, dtype):
    """``params_from_jax`` walks any tree: ``frontend/proj/w`` and the
    per-period stacked ``q_norm`` / ``k_norm`` scales cross unchanged, bit
    for bit, in the JAX dtypes (norm scales stay f32)."""
    jcfg, cfg, jp, p = _both(arch, param_dtype=dtype, activation_dtype=dtype)
    jw, tw = np.asarray(jp["frontend"]["proj"]["w"]), p["frontend"]["proj"]["w"]
    assert str(tw.dtype).removeprefix("torch.") == str(jw.dtype) == dtype
    assert tuple(tw.shape) == jw.shape == (cfg.d_model, cfg.d_model)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    tv = tw.view(torch.int16) if dtype == "bfloat16" else tw.view(torch.int32)
    np.testing.assert_array_equal(tv.numpy().view(bits), jw.view(bits))
    mixer = jp["blocks"]["pos0"]["mixer"]
    assert ("q_norm" in mixer) == cfg.qk_norm == ("q_norm" in p["blocks"]["pos0"]["mixer"])
    for name in ("q_norm", "k_norm") if cfg.qk_norm else ():
        js = np.asarray(mixer[name]["scale"])
        ts = p["blocks"]["pos0"]["mixer"][name]["scale"]
        assert ts.dtype == torch.float32 and tuple(ts.shape) == js.shape == (cfg.n_periods,
                                                                               cfg.head_dim)
        np.testing.assert_array_equal(ts.numpy(), js)
