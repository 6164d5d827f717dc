"""The port's serving engine and driver, against the JAX package.

Greedy decoding (temperature 0) only: ``jax.random`` and torch generators
draw different numbers, so sampled tokens cannot be compared.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.events import EventLog as JaxEventLog  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ARCHS = ["qwen2-0.5b", "smollm-360m"]
KERNELS = ("flash_attention", "decode_attention", "rmsnorm", "moe_gmm", "rwkv6_scan", "mamba_scan",
           "flash_attention_bwd", "rmsnorm_bwd", "decode_attention_stats", "moe_gmm_bwd")
REPO = Path(__file__).resolve().parents[1]


def _setup(arch="smollm-360m", **scfg_kw):
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, 0, device="cpu")
    log = EventLog()
    scfg = ServeConfig(**{"max_batch": 2, "max_seq": 64, **scfg_kw})
    return cfg, params, Engine(cfg, params, scfg, log=log), log


def _prompts(vocab, n=5, length=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """5 requests through 2 slots, token for token at temperature 0.

    Dense archs only: the JAX Engine writes a prefill's caches into the
    period axis of the stacked leaves (ROADMAP R4).  At reduced size
    deepseek-moe-16b has one period, so admitting slot 1 writes period 1,
    which does not exist; test_engine_matches_jax_direct_decode holds the
    MoE archs instead."""
    jcfg = jax_reduced(jax_get_config(arch))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jeng = JaxEngine(jcfg, jp, JaxServeConfig(max_batch=2, max_seq=64), log=JaxEventLog())
    eng = Engine(cfg, p, ServeConfig(max_batch=2, max_seq=64), log=EventLog())
    for prompt in _prompts(cfg.vocab_size):
        jeng.submit(prompt, max_new=6)
        eng.submit(prompt, max_new=6)
    assert eng.run_to_completion() == jeng.run_to_completion()


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-moe-16b", "rwkv6-7b", "jamba-1.5-large",
                                  "gemma2-27b", "gemma3-4b", "chameleon-34b",
                                  "musicgen-large"])
def test_engine_matches_jax_direct_decode(arch):
    """Each request's tokens equal the JAX model's own prefill + greedy
    decode loop for that request alone."""
    jcfg = jax_reduced(jax_get_config(arch))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    eng = Engine(cfg, p, ServeConfig(max_batch=2, max_seq=64), log=EventLog())
    prompts = _prompts(cfg.vocab_size, n=3)
    rids = [eng.submit(pr, max_new=5) for pr in prompts]
    res = eng.run_to_completion()
    prefill = jax.jit(lambda p, t: jax_lm.prefill(p, jcfg, t, max_seq=64))
    decode = jax.jit(lambda p, t, c, ch: jax_lm.decode_step(p, jcfg, t, c, ch))
    for rid, prompt in zip(rids, prompts):
        logits, caches = prefill(jp, jnp.asarray([prompt], jnp.int32))
        toks = [int(jnp.argmax(logits[0]))]
        for cur in range(len(prompt), len(prompt) + 4):
            logits, caches = decode(jp, jnp.asarray([toks[-1]], jnp.int32),
                                    jnp.asarray([cur], jnp.int32), caches)
            toks.append(int(jnp.argmax(logits[0])))
        assert res[rid] == toks


def _gemma_perturbed(tree, seed):
    """A copy of a JAX gemma param tree (numpy leaves) whose attention
    leaves are 6x and whose post-block norm scales are 3 + N(0, 1): at init
    a random gemma copies its last token (the scaled, tied embedding
    dominates the logits), so its greedy tokens would not depend on
    attention at all."""
    rng = np.random.default_rng(seed)

    def walk(t, path):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif "_post" in path and k == "scale":
                out[k] = (v + 3.0 + rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = (v * 6.0).astype(v.dtype) if "/mixer" in path else v
        return out

    return walk(jax.tree.map(np.asarray, tree), "")


def test_gemma3_wrapped_ring_engine_matches_jax_direct_decode():
    """Reduced gemma3-4b (window 16) served with 20-token prompts, longer
    than the window, and 8 new tokens: each local layer's 16-slot ring holds
    the prompt's last 16 positions after prefill and wraps in decode.  Each
    request's tokens equal the JAX model's own prefill + greedy decode loop
    for that request alone, and the tokens do depend on the context."""
    jcfg = jax_reduced(jax_get_config("gemma3-4b"))
    cfg = reduced(get_config("gemma3-4b"))
    noisy = _gemma_perturbed(jax_lm.init_params(jcfg, jax.random.PRNGKey(0)), 24)
    jp, p = jax.tree.map(jnp.asarray, noisy), params_from_jax(noisy, cfg, device="cpu")
    eng = Engine(cfg, p, ServeConfig(max_batch=2, max_seq=64), log=EventLog())
    prompts = _prompts(cfg.vocab_size, n=3, length=20)
    assert len(prompts[0]) > cfg.sliding_window
    rids = [eng.submit(pr, max_new=8) for pr in prompts]
    res = eng.run_to_completion()
    ring = eng.caches["blocks"]["pos0"]["mixer"]["pos_ids"]
    assert ring.shape[-1] == cfg.sliding_window
    prefill = jax.jit(lambda p, t: jax_lm.prefill(p, jcfg, t, max_seq=64))
    decode = jax.jit(lambda p, t, c, ch: jax_lm.decode_step(p, jcfg, t, c, ch))
    for rid, prompt in zip(rids, prompts):
        logits, caches = prefill(jp, jnp.asarray([prompt], jnp.int32))
        toks = [int(jnp.argmax(logits[0]))]
        for cur in range(len(prompt), len(prompt) + 7):
            logits, caches = decode(jp, jnp.asarray([toks[-1]], jnp.int32),
                                    jnp.asarray([cur], jnp.int32), caches)
            toks.append(int(jnp.argmax(logits[0])))
        assert res[rid] == toks
    assert any(len(set(res[r])) > 1 for r in rids)


def test_prefill_lands_in_its_own_slot():
    """Admitting a request copies its prefill cache into its slot of every
    layer and leaves the other slots alone."""
    cfg, params, eng, _ = _setup()
    a, b = _prompts(cfg.vocab_size, n=2)
    eng.submit(a, max_new=3)
    eng.submit(b, max_new=3)
    eng._admit()
    for slot, prompt in enumerate((a, b)):
        _, own = lm.prefill(params, cfg, torch.tensor([prompt]), max_seq=64)
        for leaf in ("k", "v", "pos_ids"):
            got = eng.caches["blocks"]["pos0"]["mixer"][leaf][:, slot]
            torch.testing.assert_close(got, own["blocks"]["pos0"]["mixer"][leaf][:, 0])


def test_rwkv_state_lands_in_its_own_slot():
    """An RWKV6 model's recurrent caches (the two shift vectors and the f32
    WKV state of every period) land in the admitted request's slot, and a
    decode tick advances each slot from its own state."""
    cfg, params, eng, _ = _setup("rwkv6-7b", max_batch=3)
    a, b = _prompts(cfg.vocab_size, n=2, length=8)
    eng.submit(a, max_new=3)
    eng.submit(b, max_new=3)
    eng._admit()
    blocks = eng.caches["blocks"]["pos0"]
    assert tuple(blocks["mixer"]["wkv"].shape)[:2] == (cfg.n_periods, 3)
    assert blocks["mixer"]["wkv"].dtype == torch.float32
    own = []
    for slot, prompt in enumerate((a, b)):
        _, c = lm.prefill(params, cfg, torch.tensor([prompt]), max_seq=64)
        own.append(c)
        for sub, leaf in (("mixer", "shift"), ("mixer", "wkv"), ("ffn", "shift")):
            torch.testing.assert_close(blocks[sub][leaf][:, slot],
                                       c["blocks"]["pos0"][sub][leaf][:, 0])
    assert float(blocks["mixer"]["wkv"][:, 2].abs().max()) == 0.0  # the free slot is untouched
    tok = [eng.active[s].out[-1] for s in (0, 1)]
    eng._decode_tick()
    for slot, prompt in enumerate((a, b)):
        _, c = lm.decode_step(params, cfg, torch.tensor([tok[slot]]),
                              torch.tensor([len(prompt)], dtype=torch.int32), own[slot])
        torch.testing.assert_close(blocks["mixer"]["wkv"][:, slot],
                                   c["blocks"]["pos0"]["mixer"]["wkv"][:, 0])


def test_mamba_state_lands_in_its_own_slot():
    """A jamba model's Mamba caches (the raw conv window and the f32 SSM
    state of every period) land in the admitted request's slot, and a
    decode tick advances each slot from its own state."""
    cfg, params, eng, _ = _setup("jamba-1.5-large", max_batch=3)
    a, b = _prompts(cfg.vocab_size, n=2, length=8)
    eng.submit(a, max_new=3)
    eng.submit(b, max_new=3)
    eng._admit()
    mixer = eng.caches["blocks"]["pos0"]["mixer"]
    assert tuple(mixer["ssm"].shape)[:2] == (cfg.n_periods, 3)
    assert mixer["ssm"].dtype == torch.float32
    own = []
    for slot, prompt in enumerate((a, b)):
        _, c = lm.prefill(params, cfg, torch.tensor([prompt]), max_seq=64)
        own.append(c)
        for leaf in ("conv", "ssm"):
            own_leaf = c["blocks"]["pos0"]["mixer"][leaf][:, 0]
            torch.testing.assert_close(mixer[leaf][:, slot], own_leaf)
    assert float(mixer["ssm"][:, 2].abs().max()) == 0.0  # the free slot is untouched
    tok = [eng.active[s].out[-1] for s in (0, 1)]
    eng._decode_tick()
    for slot, prompt in enumerate((a, b)):
        _, c = lm.decode_step(params, cfg, torch.tensor([tok[slot]]),
                              torch.tensor([len(prompt)], dtype=torch.int32), own[slot])
        for leaf in ("conv", "ssm"):
            own_leaf = c["blocks"]["pos0"]["mixer"][leaf][:, 0]
            torch.testing.assert_close(mixer[leaf][:, slot], own_leaf)


def test_continuous_batching_more_requests_than_slots():
    cfg, params, eng, log = _setup()
    rids = [eng.submit([1, 2, 3, 4], max_new=5) for _ in range(5)]
    res = eng.run_to_completion()
    assert set(res) == set(rids)
    assert all(len(v) == 5 for v in res.values())
    assert len(log.events("spawn", "request")) == 5
    assert len(log.events("exit", "request")) == 5
    assert len(log.durations("prefill")) == 5
    assert len(log.durations("decode_tick")) > 0
    assert eng.pending() == 0


def test_identical_prompts_identical_outputs():
    """Slot reuse must not leak state between requests (greedy decoding)."""
    cfg, params, eng, _ = _setup()
    rids = [eng.submit([5, 6, 7, 8], max_new=6) for _ in range(4)]
    res = eng.run_to_completion()
    assert len({tuple(res[r]) for r in rids}) == 1


def test_engine_matches_direct_decode():
    """Engine output == the port's own prefill + greedy decode loop."""
    cfg, params, eng, _ = _setup()
    prompt = [3, 1, 4, 1, 5, 9]
    rid = eng.submit(list(prompt), max_new=5)
    res = eng.run_to_completion()
    logits, caches = lm.prefill(params, cfg, torch.tensor([prompt]), max_seq=64)
    toks = [int(torch.argmax(logits[0]))]
    for cur in range(len(prompt), len(prompt) + 4):
        logits, caches = lm.decode_step(params, cfg, torch.tensor([toks[-1]]),
                                        torch.tensor([cur], dtype=torch.int32), caches)
        toks.append(int(torch.argmax(logits[0])))
    assert res[rid] == toks


def test_max_seq_bound_respected():
    cfg, params, eng, _ = _setup(max_seq=16)
    rid = eng.submit([1] * 8, max_new=100)
    assert len(eng.run_to_completion()[rid]) < 16


def test_sampling_is_seeded():
    outs = []
    for _ in range(2):
        cfg, params, eng, _ = _setup(temperature=1.0, seed=3)
        rid = eng.submit([1, 2, 3], max_new=8)
        outs.append(eng.run_to_completion()[rid])
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_serve_driver_json_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-0.5b", "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("arch", "requests", "generated_tokens", "tokens_per_s", "mean_prefill_ms",
                "wall_s", "sample", "device", "kernels"):
        assert key in rec, key
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12
    assert rec["device"] == "cpu"
    assert rec["kernels"] == dict.fromkeys(KERNELS, 0)


def test_serve_driver_runs_moe_arch_on_cpu():
    """--arch deepseek-moe-16b --reduced --device cpu: every request in full."""
    from repro_torch.launch import serve

    rec = serve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--max-batch", "2"])
    assert rec["arch"] == "deepseek-moe-16b-smoke"
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12
    assert rec["kernels"] == dict.fromkeys(KERNELS, 0)


def test_serve_driver_runs_rwkv_arch_on_cpu():
    """--arch rwkv6-7b --reduced --device cpu: 16-token prompts, one chunk
    of the reduced scan each."""
    from repro_torch.launch import serve

    rec = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--max-batch", "2"])
    assert rec["arch"] == "rwkv6-7b-smoke"
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12
    assert rec["kernels"] == dict.fromkeys(KERNELS, 0)


def test_serve_driver_runs_jamba_arch_on_cpu():
    """--arch jamba-1.5-large --reduced --device cpu: 16-token prompts, one
    chunk of the reduced scan each."""
    from repro_torch.launch import serve

    rec = serve.main(["--arch", "jamba-1.5-large", "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--max-batch", "2"])
    assert rec["arch"] == "jamba-1.5-large-smoke"
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12
    assert rec["kernels"] == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-large"])
def test_serve_driver_runs_frontend_arch_on_cpu(arch):
    """--arch chameleon-34b | musicgen-large --reduced --device cpu: served
    on tokens alone, as the JAX engine serves them."""
    from repro_torch.launch import serve

    rec = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--max-batch", "2"])
    assert rec["arch"] == f"{arch}-smoke"
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12
    assert rec["kernels"] == dict.fromkeys(KERNELS, 0)


def test_serve_driver_refuses_missing_cuda(monkeypatch):
    """Asking for cuda without a card raises; the driver never drops to CPU."""
    from repro_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_default_to_cuda(monkeypatch):
    """init_params, init_caches and params_from_jax run on cuda unless the
    caller asks for the CPU: without a card they raise, never drop to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_caches(cfg, 1, 8)
    cpu_params = lm.init_params(cfg, 0, device="cpu")
    np_params = jax.tree.map(lambda t: t.numpy(), cpu_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(np_params, cfg)
    assert params_from_jax(np_params, cfg, device="cpu")["embed"]["table"].device.type == "cpu"
