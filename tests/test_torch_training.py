"""The port's training path against the JAX package's on the CPU.

Optimizer, schedule and data against ``repro.training.optim`` and
``repro.data.pipeline`` on the same arrays; the loss and every gradient
leaf against ``jax.value_and_grad(repro.models.lm.loss_fn)`` from the same
weights (``params_from_jax``), in f32, for each arch of
``tests/test_arch_smoke.py::test_train_step`` that the port has, with the
z-loss and the MoE aux losses in; one train step with two microbatches
against the JAX step; the loss falling over 20 steps; and the driver.
On the CPU every op takes its plain version, through the same
``torch.autograd.Function``s (attention, RMSNorm) the card runs.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.training import optim as jax_optim  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training import optim  # noqa: E402
from repro_torch.training import step as step_mod  # noqa: E402

# the archs of tests/test_arch_smoke.py::test_train_step that the port has
ARCHS = ["smollm-360m", "qwen2-0.5b", "deepseek-moe-16b", "dbrx-132b", "rwkv6-7b",
         "jamba-1.5-large", "gemma2-27b", "gemma3-4b", "chameleon-34b", "musicgen-large"]
# the archs with a frontend stub, whose loss also takes (B, S, d) embeddings
FRONTEND_ARCHS = ["chameleon-34b", "musicgen-large"]
# f32 on both sides; XLA:CPU and torch sum the matmuls, the scans and the
# backward in different orders, so a leaf's gradient is held relative to
# its largest entry (up to 4e-7 seen), and the loss to 1e-5 of itself
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5


def _both(arch, **changes):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_leaves_close(jtree, ttree, rel):
    """Every leaf within ``rel`` of its own largest |entry|."""
    jf, tf = _flat(jtree), _flat(ttree)
    assert set(jf) == set(tf)
    for name, ja in jf.items():
        ja = np.asarray(ja, np.float32)
        ta = tf[name].detach().float().numpy()
        scale = max(float(np.abs(ja).max()), 1e-12)
        err = float(np.abs(ta - ja).max())
        assert err <= rel * scale, f"{name}: max |diff| {err:.3e} vs max |ref| {scale:.3e}"


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 110), (10, 25)])
def test_schedule_matches_jax(warmup, total):
    """The schedule from the step tensor, bit for bit JAX's f32 values at
    steps 0-30 (warmup, peak, cosine and, with 25 total steps, past the
    end), and at the first config's later points."""
    opt = optim.AdamWConfig(peak_lr=1.0, warmup_steps=warmup, total_steps=total,
                            min_lr_ratio=0.1)
    jopt = jax_optim.AdamWConfig(peak_lr=1.0, warmup_steps=warmup, total_steps=total,
                                 min_lr_ratio=0.1)
    for s in [*range(31), 60, 109, 110, 200]:
        got = optim.schedule(opt, torch.tensor(s, dtype=torch.int32))
        want = np.asarray(jax_optim.schedule(jopt, jnp.int32(s)))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == want.tobytes(), f"step {s}: {float(got)} vs {want}"
    assert float(optim.schedule(opt, torch.tensor(0))) == 0.0
    assert abs(float(optim.schedule(opt, torch.tensor(200))) - 0.1) < 1e-7


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype, param_dtype):
    """Five steps on a matrix (decayed), a vector (no decay) and a scalar,
    with gradients large enough that the clip acts on some steps."""
    rng = np.random.default_rng(21)
    shapes = {"w": (6, 5), "b": (5,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    kw = dict(peak_lr=0.05, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0,
              moment_dtype=moment_dtype)
    opt, jopt = optim.AdamWConfig(**kw), jax_optim.AdamWConfig(**kw)
    jd, td = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    jp = {k: jnp.asarray(v, jd) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in params.items()}
    jstate, tstate = jax_optim.init_opt_state(jp, jopt), optim.init_opt_state(tp, opt)
    assert tstate["mu"]["w"].dtype == getattr(torch, moment_dtype)
    for i in range(5):
        g = {k: np.asarray(rng.standard_normal(s) * (3.0 if i % 2 else 0.1), np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = jax_optim.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                                jstate, jopt)
        tp, tstate, tm = optim.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                            tstate, opt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"].numpy().tobytes() == np.asarray(jm["lr"]).tobytes()
        assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        # one f32 update rounded to the param dtype; bf16 may land one ulp apart
        tol = 1e-5 if param_dtype == "float32" and moment_dtype == "float32" else 1e-2
        for k in shapes:
            np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                       atol=tol, rtol=tol, err_msg=f"step {i} {k}")
            assert tp[k].dtype == td and tstate["nu"][k].dtype == getattr(torch, moment_dtype)


def test_adamw_converges_quadratic():
    opt = optim.AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optim.init_opt_state(params, opt)
    for _ in range(200):
        params, state, _ = optim.adamw_update(params, {"w": 2 * params["w"]}, state, opt)
    assert float(params["w"].abs().max()) < 0.05


def test_global_norm_and_clip_metric():
    rng = np.random.default_rng(22)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    want = float(jax_optim.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(optim.global_norm({"a": torch.from_numpy(tree["a"]),
                                   "b": {"c": torch.from_numpy(tree["b"]["c"])}}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    opt = optim.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    _, _, m = optim.adamw_update(params, {"w": torch.full((3,), 100.0)},
                                 optim.init_opt_state(params, opt), opt)
    assert float(m["grad_norm"]) > 100.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,index,n_shards,shard", [(0, 0, 1, 0), (3, 7, 1, 0), (5, 2, 2, 1),
                                                        (11, 0, 4, 3)])
def test_synthetic_lm_batches_match_jax(seed, index, n_shards, shard):
    kw = dict(vocab_size=257, seq_len=33, global_batch=8, seed=seed, n_shards=n_shards,
              shard=shard)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch(index)
    want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(**kw)).batch(index)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn's loss, its parts and every gradient leaf, f32, against
    jax.value_and_grad(lm.loss_fn) (B x S = 64 tokens in two loss chunks)."""
    jcfg, cfg, jp, tp = _both(arch)
    B, S = 2, 32
    toks = np.random.default_rng(31).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return jax_lm.loss_fn(p, jcfg, jnp.asarray(x), jnp.asarray(y))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = step_mod._requires_grad(tp)
    tl, tm = lm.loss_fn(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    leaves = optim.leaves(tp)
    tg = step_mod._rebuild(tp, iter(step_mod._grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    for k in ("ce", "z_loss", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL, atol=1e-9,
                                   err_msg=k)
    if cfg.moe is not None:
        assert float(tm["aux"]) > 0
    assert float(tm["z_loss"]) > 0
    _assert_leaves_close(jg, tg, GRAD_TOL)


def _perturb_scales(tree, seed):
    """A copy of a JAX param tree whose RMSNorm scales (zeros at init) are
    N(0, 0.5), so each norm's scale, QK-norm's included, reaches the loss."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * 0.5).astype(v.dtype) if k == "scale" else v
                for k, v in t.items()}

    return walk(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_loss_and_grads_with_frontend_match_jax(arch):
    """loss_fn with frontend embeddings, its parts and every gradient leaf
    (``frontend/proj``, and chameleon's ``q_norm`` / ``k_norm`` among them),
    f32, against jax.value_and_grad(lm.loss_fn), norm scales perturbed."""
    jcfg, cfg, jp, _ = _both(arch)
    np_p = _perturb_scales(jp, 36)
    jp, tp = jax.tree.map(jnp.asarray, np_p), params_from_jax(np_p, cfg, device="cpu")
    B, S = 2, 32
    rng = np.random.default_rng(37)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    fe = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x, y = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return jax_lm.loss_fn(p, jcfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(fe))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = step_mod._requires_grad(tp)
    tl, tm = lm.loss_fn(tp, cfg, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(fe))
    tg = step_mod._rebuild(tp, iter(step_mod._grad(tl, optim.leaves(tp))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    for k in ("ce", "z_loss", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL, atol=1e-9,
                                   err_msg=k)
    _assert_leaves_close(jg, tg, GRAD_TOL)
    named = _flat(tg)
    assert float(named["/frontend/proj/w"].abs().max()) > 0
    for name in ("q_norm", "k_norm") if cfg.qk_norm else ():
        assert float(named[f"/blocks/pos0/mixer/{name}/scale"].abs().max()) > 0
    # without the embeddings the loss is another one
    with torch.no_grad():
        bare, _ = lm.loss_fn(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(bare) - float(tl)) > 1e-3


# the dense archs the card trains with K1b at their own head dims (256 and
# 128; the reduced configs' 16 never reach the wide pair's head dims), at 2
# layers: gemma3-4b one local and one global (its pattern of 5 local to 1
# global, cut to one period of (swa, ga)), chameleon-34b two QK-normed
# layers, with embeddings
@pytest.mark.parametrize("arch,head_dim", [("gemma3-4b", 256), ("chameleon-34b", 128)])
def test_loss_and_grads_at_the_full_head_dim_match_jax(arch, head_dim):
    """loss_fn's loss, its parts and every gradient leaf at the arch's own
    head dim, 2 layers, norm scales perturbed, f32, against
    jax.value_and_grad(lm.loss_fn); chameleon-34b with frontend
    embeddings."""
    from repro.configs.base import LayerSpec as JaxLayerSpec

    from repro_torch.configs.base import LayerSpec

    pattern = {"gemma3-4b": ("swa", "ga"), "chameleon-34b": ("ga",)}[arch]
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), n_layers=2, head_dim=head_dim,
                               layer_pattern=tuple(JaxLayerSpec(m) for m in pattern))
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=2, head_dim=head_dim,
                              layer_pattern=tuple(LayerSpec(m) for m in pattern))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    np_p = _perturb_scales(jp, 39)
    jp, tp = jax.tree.map(jnp.asarray, np_p), params_from_jax(np_p, cfg, device="cpu")
    assert tuple(tp["blocks"]["pos0"]["mixer"]["q"]["w"].shape)[-2:] == (cfg.n_heads, head_dim)
    B, S = 2, 32
    rng = np.random.default_rng(40)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    fe = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
          if cfg.frontend is not None else None)

    def jloss(p):
        return jax_lm.loss_fn(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                              None if fe is None else jnp.asarray(fe))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = step_mod._requires_grad(tp)
    tl, tm = lm.loss_fn(tp, cfg, torch.from_numpy(x), torch.from_numpy(y),
                        None if fe is None else torch.from_numpy(fe))
    tg = step_mod._rebuild(tp, iter(step_mod._grad(tl, optim.leaves(tp))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    for k in ("ce", "z_loss", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL, atol=1e-9,
                                   err_msg=k)
    _assert_leaves_close(jg, tg, GRAD_TOL)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policies_give_the_same_grads(policy):
    """Per-period checkpointing recomputes the same values: every gradient
    leaf of loss_fn equals the no-remat ("everything") one."""
    _, cfg, _, tp = _both("qwen2-0.5b", n_layers=3)
    toks = torch.from_numpy(np.random.default_rng(32).integers(0, cfg.vocab_size, (2, 17)))
    grads = {}
    for pol in ("everything", policy):
        c = dataclasses.replace(cfg, remat_policy=pol)
        p = step_mod._requires_grad({k: v for k, v in tp.items()})
        loss, _ = lm.loss_fn(p, c, toks[:, :-1], toks[:, 1:])
        grads[pol] = step_mod._grad(loss, optim.leaves(p))
    for a, b in zip(grads["everything"], grads[policy]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_loss_chunk_fallback_and_forward_aux():
    """A token count the chunk does not divide takes one chunk of all of
    them, as in the JAX loss; the forward's aux is the MoE layers' sum and
    the serving surfaces keep their signatures."""
    jcfg, cfg, jp, tp = _both("deepseek-moe-16b", loss_chunk=24)
    toks = np.random.default_rng(33).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, _ = jax_lm.loss_fn(jp, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    with torch.no_grad():
        tl, tm = lm.loss_fn(tp, cfg, torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
        hidden, aux, caches = lm.forward(tp, cfg, torch.from_numpy(toks), return_aux=True)
        hidden2, caches2 = lm.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    assert float(tm["tokens"]) == 40 and float(aux) > 0 and caches is None and caches2 is None
    torch.testing.assert_close(hidden, hidden2)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_train_step_with_microbatches_matches_jax():
    """One step with two microbatches, from the same weights and batch:
    the updated params, the loss and the grad norm against the JAX step."""
    jcfg, cfg, jp, tp = _both("smollm-360m")
    tcfg = step_mod.TrainConfig(microbatches=2)
    jtcfg = jax_step.TrainConfig(microbatches=2)
    toks = np.random.default_rng(34).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jstate = {"params": jp, "opt": jax_optim.init_opt_state(jp, jtcfg.opt)}
    jstate, jm = jax_step.make_train_step(jcfg, jtcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = step_mod.init_train_state(cfg, tcfg, params=tp)
    state, m = step_mod.make_train_step(cfg, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "z_loss", "aux", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    # the first step moves each weight by ~lr (Adam's normalised update), so
    # the params agree to well under it
    _assert_leaves_close(jstate["params"], state["params"], 1e-5)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_train_step_with_microbatches_and_frontend_matches_jax(arch):
    """One step with two microbatches and frontend embeddings, split with
    the tokens as the JAX step splits them: params, loss and grad norm."""
    jcfg, cfg, jp, tp = _both(arch)
    tcfg = step_mod.TrainConfig(microbatches=2)
    jtcfg = jax_step.TrainConfig(microbatches=2)
    rng = np.random.default_rng(38)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frontend_embed": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)}
    jstate = {"params": jp, "opt": jax_optim.init_opt_state(jp, jtcfg.opt)}
    jstate, jm = jax_step.make_train_step(jcfg, jtcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = step_mod.init_train_state(cfg, tcfg, params=tp)
    state, m = step_mod.make_train_step(cfg, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "z_loss", "aux", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    _assert_leaves_close(jstate["params"], state["params"], 1e-5)


def test_compiled_train_step_refuses_frontend_embed():
    """A compiled step built for tokens and labels alone (its first call)
    refuses a batch with embeddings: it never runs them as another input
    set, nor drops them."""
    from repro_torch.training.compiled import CompiledTrainStep

    cfg = reduced(get_config("musicgen-large"))
    tcfg = step_mod.TrainConfig()
    state = step_mod.init_train_state(cfg, tcfg, 0, "cpu")
    step = CompiledTrainStep(cfg, tcfg, state)
    toks = torch.zeros(2, 8, dtype=torch.long)
    step(state, {"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match="built for"):
        step(state, {"tokens": toks, "labels": toks,
                     "frontend_embed": torch.zeros(2, 8, cfg.d_model)})
    assert step.counts()["calls"] == 1


def test_microbatches_match_the_full_batch():
    toks = np.random.default_rng(35).integers(0, 256, (4, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    out = {}
    for n in (1, 2):
        _, cfg, _, tp = _both("smollm-360m", z_loss_weight=0.0)  # the same weights each time
        tcfg = step_mod.TrainConfig(microbatches=n)
        state = step_mod.init_train_state(cfg, tcfg, params=tp)
        out[n], _ = step_mod.make_train_step(cfg, tcfg)(state, batch)
    for a, b in zip(optim.leaves(out[1]["params"]), optim.leaves(out[2]["params"])):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_loss_descends_20_steps():
    """The port's copy of tests/test_training.py::test_loss_descends_20_steps."""
    cfg = reduced(get_config("qwen2-0.5b"))
    tcfg = step_mod.TrainConfig(opt=optim.AdamWConfig(peak_lr=1e-2, warmup_steps=5,
                                                      total_steps=100))
    state = step_mod.init_train_state(cfg, tcfg, 0, "cpu")
    step = step_mod.make_train_step(cfg, tcfg)
    data = pipeline.SyntheticLM(pipeline.DataConfig(cfg.vocab_size, 32, 4, seed=3))
    losses = []
    for i in range(20):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_train_params_require_grad_and_serving_params_do_not():
    cfg = reduced(get_config("smollm-360m"))
    state = step_mod.init_train_state(cfg, step_mod.TrainConfig(), 0, "cpu")
    assert all(t.requires_grad for t in optim.leaves(state["params"]))
    assert not any(t.requires_grad for t in optim.leaves(lm.init_params(cfg, 0, "cpu")))
    assert all(t.dtype == torch.float32 for t in optim.leaves(state["opt"]["mu"]))


def test_attention_and_rmsnorm_train_through_their_functions(monkeypatch):
    """Under grad the auto route runs the autograd.Functions (whose CPU
    insides are the plain versions); without grad it calls the wrappers."""
    calls = []
    for cls in (ops.Attention, ops.RMSNorm):
        def spy(ctx, *a, _orig=cls.forward, _name=cls.__name__):
            calls.append(_name)
            return _orig(ctx, *a)

        monkeypatch.setattr(cls, "forward", staticmethod(spy))
    cfg = reduced(get_config("smollm-360m"))
    p = step_mod._requires_grad(lm.init_params(cfg, 0, "cpu"))
    toks = torch.zeros(1, 9, dtype=torch.long)
    with torch.no_grad():
        lm.loss_fn(p, cfg, toks[:, :-1], toks[:, 1:])
    assert calls == []
    lm.loss_fn(p, cfg, toks[:, :-1], toks[:, 1:])
    assert calls.count("Attention") == cfg.n_layers
    assert calls.count("RMSNorm") == 2 * cfg.n_layers + 1


def test_train_driver_on_the_cpu(tmp_path, capsys):
    rec = train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                          "--steps", "3", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert line["arch"] == "smollm-360m-smoke" and line["steps"] == 3
    assert np.isfinite(line["first_loss"]) and np.isfinite(line["last_loss"])
    assert line["device"] == "cpu" and not any(line["kernels"].values())
    assert set(line) >= {"first_loss", "last_loss", "tokens_per_s", "wall_s", "restarts",
                         "stragglers", "compiled"}
    assert line["restarts"] == 0 and line["compiled"]["captures"] == 0


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch and the port only in its
    functions)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,changes", [
    ("smollm-360m", {}), ("gemma3-4b", {"n_layers": 8}), ("gemma3-4b", {"n_layers": 2}),
    ("gemma2-27b", {"n_layers": 4}), ("chameleon-34b", {"n_layers": 3}),
    ("musicgen-large", {"n_layers": 2}), ("qwen2-0.5b", {"remat_policy": "everything"}),
])
def test_chip_smoke_train_launches_per_step(arch, changes):
    """chip_smoke.py's count of each step's kernel launches (which it holds
    every train step on the card to) is the number of calls the step makes
    to each kernel wrapper, counted here on the CPU, where the wrappers run
    their plain versions: per-period remat runs the periods' forward again,
    not the unscanned tail's or the final norm."""
    from repro_torch.configs.base import LayerSpec

    cfg = dataclasses.replace(reduced(get_config(arch)), remat_policy="nothing")
    if arch == "gemma3-4b" and changes["n_layers"] == 2:
        changes = {**changes, "layer_pattern": (LayerSpec("swa"), LayerSpec("ga"))}
    cfg = dataclasses.replace(cfg, **changes)
    calls = dict.fromkeys(("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"), 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    tcfg = step_mod.TrainConfig()
    state = step_mod.init_train_state(cfg, tcfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(41).integers(0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend != "text":
        batch["frontend_embed"] = torch.zeros(2, 16, cfg.d_model)
    with pytest.MonkeyPatch.context() as mp:
        for name, attr in (("flash_attention", "_fa_kernel"),
                           ("flash_attention_bwd", "_fa_bwd_kernel"),
                           ("rmsnorm", "_rmsnorm_kernel"), ("rmsnorm_bwd", "_rmsnorm_bwd_kernel")):
            mp.setattr(ops, attr, counted(name, getattr(ops, attr)))
        step_mod.make_train_step(cfg, tcfg)(state, batch)
    want = _chip_smoke().train_launches_per_step(cfg)
    assert {k: want[k] for k in calls} == calls
    assert all(v == 0 for k, v in want.items() if k not in calls)
    assert calls["flash_attention_bwd"] == cfg.n_layers


def test_adamw_update_in_chunks_gives_the_whole_leafs_bits(monkeypatch):
    """adamw_update takes a leaf UPDATE_CHUNK elements at a time: with
    chunks of 7 elements (ragged against every leaf) the params and moments
    are the bits of one chunk per leaf, decayed (a matrix) and not (a
    vector), with the clip acting."""
    rng = np.random.default_rng(42)
    shapes = {"w": (5, 13), "b": (11,), "s": ()}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in
              shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) * 10 for k, s in
             shapes.items()}
    opt = optim.AdamWConfig(warmup_steps=2, total_steps=10, grad_clip=1.0)
    out = {}
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(optim, "UPDATE_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        state = optim.init_opt_state(p, opt)
        for _ in range(3):
            optim.adamw_update(p, grads, state, opt)
        out[chunk] = optim.leaves(p) + optim.leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(out[1 << 26], out[7]))
    with pytest.raises(ValueError, match="contiguous"):
        optim.adamw_update({"w": params["w"].t()}, {"w": grads["w"].t()},
                           optim.init_opt_state({"w": params["w"]}, opt), opt)
