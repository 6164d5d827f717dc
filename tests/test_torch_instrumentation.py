"""The port's measurement layer against the JAX package's, on the CPU.

Static tracepoints (``repro_torch.core.tracepoints``) against
``repro.core.tracepoints``: the tape of ``prefill``, ``decode_step``,
``loss_fn`` and the train step, values within atol = rtol = 1e-5 in f32
(XLA:CPU and torch sum in other orders) and fire counts equal; callback
events within 1e-4 (whole arrays after the layers); the aggregation rules;
disabled points dispatch no op; tape mode adds only 0-dim ops; callback
mode refuses a CUDA graph capture.  Dynamic probes
(``repro_torch.core.uprobes``): ``attach`` on the port's RMSNorm gives
the JAX attach's ``:ret`` values (1e-5), ``inject_probes`` leaves outputs
bit-equal.  The microbench against JAX's (1e-6 relative), the overhead
harness's statistics against JAX's (exact), the Table I / Fig. 2 arms on
the CPU, and R13: the compiled engine's bound on prefill graphs.

Both sides run the same weights, converted by ``params_from_jax``; inputs
come from numpy seeds.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import microbench as jax_microbench  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import overhead as jax_overhead  # noqa: E402
from repro.core import tracepoints as jax_tp  # noqa: E402
from repro.core import uprobes as jax_uprobes  # noqa: E402
from repro.core.events import EventLog as JaxEventLog  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.nn import core as jax_nn  # noqa: E402
from repro.training import optim as jax_optim  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.configs import get_config, microbench, reduced  # noqa: E402
from repro_torch.core import overhead, scopes, uprobes  # noqa: E402
from repro_torch.core import tracepoints as tp  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.nn import core as nn_core  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.training import step as step_mod  # noqa: E402
from repro_torch.training.compiled import CompiledTrainStep  # noqa: E402

TAPE_TOL = dict(atol=1e-5, rtol=1e-5)
ARRAY_TOL = dict(atol=1e-4, rtol=1e-4)
# reduced dense, MoE and RWKV archs; prompts of 16 tokens (the RWKV chunk)
TAPE_ARCHS = ["qwen2-0.5b", "deepseek-moe-16b", "rwkv6-7b"]
B, S = 2, 16


def _both(arch):
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _surfaces(jcfg, cfg, jp, p):
    """{surface: (jax fn, port fn)}, each a no-argument call of one surface
    on the same tokens; decode runs against each side's own prefill."""
    toks = _tokens(cfg)
    labels = np.roll(toks, -1, 1)
    jt, t = jnp.asarray(toks), torch.from_numpy(toks)
    _, jcaches = jax_lm.prefill(jp, jcfg, jt, max_seq=S + 4)
    _, caches = lm.prefill(p, cfg, t, max_seq=S + 4)
    nxt = np.array([3, 5])
    return {
        "prefill": (lambda: jax_lm.prefill(jp, jcfg, jt, max_seq=S + 4)[0],
                    lambda: lm.prefill(p, cfg, t, max_seq=S + 4)[0]),
        "decode": (lambda: jax_lm.decode_step(jp, jcfg, jnp.asarray(nxt),
                                              jnp.full((B,), S, jnp.int32), jcaches)[0],
                   lambda: lm.decode_step(p, cfg, torch.from_numpy(nxt),
                                          torch.full((B,), S, dtype=torch.int32),
                                          {k: _clone(v) for k, v in caches.items()})[0]),
        "loss": (lambda: jax_lm.loss_fn(jp, jcfg, jt, jnp.asarray(labels))[0],
                 lambda: lm.loss_fn(p, cfg, t, torch.from_numpy(labels))[0]),
    }


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _assert_tapes_equal(jtape, tape):
    assert set(tape) == set(jtape)
    for name, (jv, jn) in jtape.items():
        v, n = tape[name]
        assert n == int(jn), name
        assert v.dim() == 0, name
        np.testing.assert_allclose(float(v), float(jv), err_msg=name, **TAPE_TOL)


# ---------------------------------------------------------------------------
# Static tracepoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("surface", ["prefill", "decode", "loss"])
@pytest.mark.parametrize("arch", TAPE_ARCHS)
def test_tape_equals_jax(arch, surface):
    """The model's points fire at the JAX sites with the JAX values and
    counts (lm.embed_out, lm.stack_out and the surface's own point)."""
    jfn, fn = _surfaces(*_both(arch))[surface]
    with jax_tp.enable("tape"):
        _, jtape = jax_tp.collect(jfn)()
    with tp.enable("tape"), torch.no_grad():
        _, tape = tp.collect(fn)()
    want = {"prefill": "lm.prefill_logits", "decode": "lm.decode_logits", "loss": "lm.loss"}
    assert set(tape) == {"lm.embed_out", "lm.stack_out", want[surface]}
    _assert_tapes_equal(jtape, tape)


def test_train_step_tape_equals_jax():
    """train.loss and train.grad_norm of one step from the same weights and
    batch.  The JAX step's tape also holds the model's points, but those
    fire inside ``value_and_grad`` and hold its tracers, which escape it:
    only the step-level points compare (the port's lm.loss is the loss)."""
    jcfg, cfg, jp, p = _both("smollm-360m")
    toks = _tokens(cfg, 7, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jtcfg, tcfg = jax_step.TrainConfig(), step_mod.TrainConfig()
    jstate = {"params": jp, "opt": jax_optim.init_opt_state(jp, jtcfg.opt)}
    with jax_tp.enable("tape"):
        (_, jm), jtape = jax_tp.collect(jax_step.make_train_step(jcfg, jtcfg))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = step_mod.init_train_state(cfg, tcfg, params=p)
    with tp.enable("tape"):
        (_, m), tape = tp.collect(step_mod.make_train_step(cfg, tcfg))(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tape) == set(jtape) == {"train.loss", "train.grad_norm", "lm.loss",
                                       "lm.embed_out", "lm.stack_out"}
    step_points = ("train.loss", "train.grad_norm")
    _assert_tapes_equal({k: jtape[k] for k in step_points}, {k: tape[k] for k in step_points})
    assert float(tape["train.loss"][0]) == float(tape["lm.loss"][0]) == float(m["loss"])


def test_compiled_train_step_returns_its_tape():
    """The compiled step's tape (eager on the CPU, through its static
    buffers) holds train.loss equal to the step's loss metric, at each call."""
    _, cfg, _, p = _both("smollm-360m")
    tcfg = step_mod.TrainConfig()
    state = step_mod.init_train_state(cfg, tcfg, params=p)
    cstep = CompiledTrainStep(cfg, tcfg, state)
    toks = torch.from_numpy(_tokens(cfg, 8, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with tp.enable("tape"):
        for _ in range(2):
            _, m = cstep(state, batch)
            assert cstep.tape["train.loss"][0].item() == m["loss"].item()
            assert cstep.tape["train.grad_norm"][0].item() == m["grad_norm"].item()
    _, m = cstep(state, batch)  # tracing disabled: an empty tape
    assert cstep.tape == {}


def _agg_fns(agg):
    def body(point, x, i):
        point("p", x * (i + 1), agg=agg) if agg != "count" else point("p", None)

    return body


@pytest.mark.parametrize("agg", ["last", "sum", "max", "count"])
def test_tape_agg_modes_match_jax(agg):
    """Three fires of one point combine as in the JAX package (its
    test_tape_agg_modes): last 6, sum 12, max 6, count 3."""
    body = _agg_fns(agg)

    def jf(x):
        for i in range(3):
            body(jax_tp.point, x, i)
        return x

    def f(x):
        for i in range(3):
            body(tp.point, x, i)
        return x

    with jax_tp.enable("tape"):
        _, jtape = jax.jit(jax_tp.collect(jf))(jnp.float32(2.0))
    with tp.enable("tape"):
        _, tape = tp.collect(f)(torch.tensor(2.0))
    want = {"last": 6.0, "sum": 12.0, "max": 6.0, "count": 3}[agg]
    assert float(tape["p"][0]) == float(jtape["p"][0]) == want
    assert tape["p"][1] == int(jtape["p"][1]) == 3


class _OpLog(TorchDispatchMode):
    """Records (op, output shapes) of every dispatched aten op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = tuple(tuple(t.shape) for t in torch.utils._pytree.tree_leaves(out)
                       if isinstance(t, torch.Tensor))
        self.ops.append((str(func), shapes))
        return out


def _op_log(fn):
    with torch.no_grad(), _OpLog() as rec:
        fn()
    return rec.ops


@pytest.mark.parametrize("surface", ["prefill", "decode", "loss"])
def test_disabled_points_dispatch_no_op(surface, monkeypatch):
    """With tracing disabled the op sequence equals that with every point
    replaced by a bare no-op."""
    _, fn = _surfaces(*_both("qwen2-0.5b"))[surface]
    with_points = _op_log(fn)
    monkeypatch.setattr(tp, "point", lambda *a, **k: None)
    without = _op_log(fn)
    assert with_points == without and len(without) > 50


@pytest.mark.parametrize("surface", ["prefill", "decode", "loss"])
def test_tape_mode_adds_only_0dim_ops(surface):
    """Tape mode's extra ops are a few, each with 0-dim outputs only, and
    the step's own ops stay in their order."""
    _, fn = _surfaces(*_both("qwen2-0.5b"))[surface]
    plain = _op_log(fn)
    with tp.enable("tape"):
        taped = _op_log(tp.collect(fn))
    extra = list(taped)
    for op in plain:  # plain is a subsequence of taped
        extra.remove(op)
    assert [op for op in taped if op not in extra] == plain
    assert 0 < len(extra) <= 6
    assert all(shapes and all(s == () for s in shapes) for _, shapes in extra), extra


def test_callback_events_equal_jax():
    """Callback mode records each point's value on the host: the same names
    in the same order as the JAX callbacks, the same values."""
    jcfg, cfg, jp, p = _both("qwen2-0.5b")
    jfn, fn = _surfaces(jcfg, cfg, jp, p)["prefill"]
    jlog, log = JaxEventLog(), EventLog()
    with jax_tp.enable("callback", log=jlog):
        jax.block_until_ready(jfn())
    jax.effects_barrier()
    with tp.enable("callback", log=log), torch.no_grad():
        fn()
    jev, ev = jlog.events("probe"), log.events("probe")
    assert [e.name for e in ev] == [e.name for e in jev] == [
        "lm.embed_out", "lm.stack_out", "lm.prefill_logits"]
    for je, e in zip(jev, ev):
        got = e.payload.numpy() if isinstance(e.payload, torch.Tensor) else e.payload
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(je.payload, np.float32), err_msg=e.name,
                                   **ARRAY_TOL)


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


@pytest.mark.parametrize("trap", ["tracepoint", "attach", "inject"])
def test_traps_refuse_a_capture(trap, monkeypatch):
    """A trap reads a value to the host, which a CUDA graph capture cannot
    do: callback mode, an attached probe's :ret and an injected callback
    probe raise, naming the capture, and run nothing eagerly instead."""
    x = torch.arange(4.0)
    log = EventLog()
    _capturing(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        if trap == "tracepoint":
            with tp.enable("callback", log=log):
                tp.point("p", x)
        elif trap == "attach":
            with uprobes.ProbeRegistry(log) as reg:
                reg.attach(microbench, "approx_sqrt_workload")
                microbench.approx_sqrt_workload(x + 1)
        else:
            uprobes.inject_probes(microbench.approx_sqrt_workload,
                                  uprobes.by_primitive("clamp_min"), log=log)(x + 1)
    assert not any(e.name.endswith("ret") or "#" in e.name or e.name == "p"
                   for e in log.events("probe"))


def test_tape_mode_is_not_refused_in_a_capture(monkeypatch):
    """Tape mode dispatches device ops only: a capture may hold it."""
    _capturing(monkeypatch)
    with tp.enable("tape"):
        _, tape = tp.collect(lambda: tp.point("p", torch.arange(4.0)))()
    assert float(tape["p"][0]) == 1.5


# ---------------------------------------------------------------------------
# Dynamic probes
# ---------------------------------------------------------------------------


def test_attach_rmsnorm_matches_jax_and_detaches():
    """attach on nn.core.rmsnorm, on both sides, over the same prefill: the
    same :ret values (the first element of each norm's output), one :enter
    / :exit pair a call in the port; detach_all restores the symbol.  JAX's
    ``jax.debug.callback`` is unordered (two norms of one scan iteration
    may arrive swapped), so the values compare as sorted lists; the port's
    come in call order."""
    jcfg, cfg, jp, p = _both("qwen2-0.5b")
    jfn, fn = _surfaces(jcfg, cfg, jp, p)["prefill"]
    jlog, log = JaxEventLog(), EventLog()
    original = nn_core.rmsnorm
    with jax_uprobes.ProbeRegistry(jlog) as jreg:
        jreg.attach(jax_nn, "rmsnorm")
        jax.block_until_ready(jfn())
        jax.effects_barrier()
    with uprobes.ProbeRegistry(log) as reg:
        reg.attach(nn_core, "rmsnorm")
        assert nn_core.rmsnorm is not original
        with torch.no_grad():
            fn()
    assert nn_core.rmsnorm is original
    jret = [e.payload for e in jlog.events("probe") if e.name.endswith(":ret")]
    ret = [e.payload for e in log.events("probe") if e.name.endswith(":ret")]
    assert len(ret) == len(jret) == 2 * cfg.n_layers + 1
    np.testing.assert_allclose(np.sort(ret), np.sort(np.array(jret, np.float32)), **TAPE_TOL)
    names = [e.name for e in log.events("probe")]
    assert names == ["repro_torch.nn.core.rmsnorm:" + s for s in ("enter", "ret", "exit")
                     ] * len(ret)


def _count_ops(fn, matcher):
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            Count.n += bool(matcher(uprobes.op_site(func)))
            return out

    with torch.no_grad(), Count():
        fn()
    return Count.n


@pytest.mark.parametrize("matcher", ["mm", "final_norm"])
def test_inject_probes_bit_equal_and_taps_count_matched_ops(matcher):
    """inject_probes leaves a prefill's logits bit-equal; its taps count the
    ops the matcher accepts (by name, or by scope), and by_scope hits only
    ops inside that scope."""
    _, fn = _surfaces(*_both("qwen2-0.5b"))["prefill"]
    m = (uprobes.by_primitive("mm") if matcher == "mm" else uprobes.by_scope("final_norm"))
    with torch.no_grad():
        want = fn()
        got, taps = uprobes.inject_probes(fn, m, mode="tap")()
    assert torch.equal(got, want)
    n = _count_ops(fn, m)
    assert len(taps) == n > 0
    assert all(v.dim() == 0 for v in taps.values())
    if matcher == "final_norm":
        seen = []
        with torch.no_grad():
            uprobes.inject_probes(fn, lambda s: m(s) and not seen.append(s.scope),
                                  mode="tap")()
        assert seen and all(s == "final_norm" for s in seen)


def test_inject_probes_callback_records_one_event_a_hit():
    log = EventLog()
    x = microbench.make_inputs("cpu")
    out = uprobes.inject_probes(microbench.approx_sqrt_workload,
                                uprobes.by_primitive("clamp_min"), log=log)(x)
    assert torch.equal(out, microbench.approx_sqrt_workload(x))
    assert [(e.name, e.payload) for e in log.events("probe")] == [("clamp_min#0", 1.0)]


def test_scopes_follow_the_jax_model():
    """The port's scope paths are the JAX model's named scopes."""
    _, fn = _surfaces(*_both("qwen2-0.5b"))["prefill"]
    seen = set()

    class Scopes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(scopes.current())
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Scopes():
        fn()
    assert seen == {"", "embed", "pos0_ga_dense", "pos0_ga_dense/mixer_ga",
                    "pos0_ga_dense/ffn_dense", "final_norm"}
    assert scopes.current() == ""


# ---------------------------------------------------------------------------
# The microbench and the overhead harness
# ---------------------------------------------------------------------------


def test_microbench_matches_jax():
    x = microbench.make_inputs("cpu")
    jx = jax_microbench.make_inputs()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(microbench.approx_sqrt_workload(x).numpy(),
                               np.asarray(jax_microbench.approx_sqrt_workload(jx)), rtol=1e-6)
    with tp.enable("tape"):
        _, tape = tp.collect(microbench.approx_sqrt_workload)(x)
    with jax_tp.enable("tape"):
        _, jtape = jax.jit(jax_tp.collect(jax_microbench.approx_sqrt_workload))(jx)
    _assert_tapes_equal(jtape, tape)


def test_make_inputs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        microbench.make_inputs()


SAMPLES = [[1.0], [3.0, 1.0], [1.5, 0.5, 2.5, 1.0], list(np.linspace(0.9, 1.3, 101))]


@pytest.mark.parametrize("samples", SAMPLES, ids=["one", "two", "four", "hundred-one"])
def test_stats_and_table_equal_jax(samples):
    kw = dict(user_s=0.25, system_s=0.125)
    rows = [overhead.stats_from_samples(lab, [s * f for s in samples], **kw)
            for lab, f in (("baseline", 1.0), ("usdt", 1.05), ("uprobes", 1.5))]
    jrows = [jax_overhead.stats_from_samples(lab, [s * f for s in samples], **kw)
             for lab, f in (("baseline", 1.0), ("usdt", 1.05), ("uprobes", 1.5))]
    assert [r.row() for r in rows] == [r.row() for r in jrows]
    assert overhead.table(rows) == jax_overhead.table(jrows)
    assert rows[1].overhead_vs(rows[0]) == jrows[1].overhead_vs(jrows[0])


def test_table1_and_fig2_arms_on_the_cpu():
    """The Table I arms on the CPU (no graph arms there), and Fig. 2's
    split beside them."""
    rows = overhead.bench_microbench(warmup=2, runs=5, device="cpu")
    assert [r.label for r in rows] == ["baseline", "usdt", "uprobes"]
    assert all(r.runs == 5 and r.min_ms <= r.median_ms <= r.max_ms for r in rows)
    fig2 = overhead.breakdown_fig2(rows)
    assert fig2[0]["delta_user_s"] == 0.0 and [r["label"] for r in fig2] == [
        "baseline", "usdt", "uprobes"]
    assert "uprobes" in overhead.fig2_table(rows)
    cfg = reduced(get_config("qwen2-0.5b"))
    rows = overhead.bench_model_step(cfg, lm.init_params(cfg, 0, "cpu"), batch=2, seq=32,
                                     warmup=1, runs=3, device="cpu")
    assert [r.label for r in rows] == ["baseline", "usdt", "uprobes"]


def test_model_step_uprobes_arm_hits_once_a_call():
    """The model arm's matcher (the token embedding) fires once a call, as
    the JAX harness's scan matcher does on the microbench."""
    _, cfg, _, p = _both("qwen2-0.5b")
    toks, labels = overhead.model_step_inputs(cfg, 2, 16, torch.device("cpu"))
    n = _count_ops(lambda: lm.loss_fn(p, cfg, toks, labels), uprobes.by_primitive("embedding"))
    assert n == 1


# ---------------------------------------------------------------------------
# R13: the compiled engine keeps a bounded number of prefill graphs
# ---------------------------------------------------------------------------


def test_engine_bounds_its_prefill_graphs():
    """A cap of 2 over 4 prompt lengths (each served twice in a row, then the
    first again): 2 steps kept, the rest evicted least recently used first,
    and the tokens equal the uncompiled engine's."""
    _, cfg, _, p = _both("qwen2-0.5b")
    rng = np.random.default_rng(11)
    lens = [8, 8, 12, 12, 16, 16, 20, 20, 8]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    outs = {}
    for compiled in (False, True):
        eng = Engine(cfg, p, ServeConfig(max_batch=2, max_seq=48), compiled=compiled,
                     max_prefill_graphs=2)
        rids = [eng.submit(pr, max_new=5) for pr in prompts]
        res = eng.run_to_completion()
        outs[compiled] = [res[r] for r in rids]
    assert outs[True] == outs[False]
    counts = eng.compiled_counts()
    assert list(counts["prefill"]) == [20, 8]  # 8 came back after 12 and 16 evicted it
    assert counts["prefill"][8]["calls"] == 1 and counts["prefill_evictions"] == 3
    with pytest.raises(ValueError):
        Engine(cfg, p, ServeConfig(max_batch=2, max_seq=48), max_prefill_graphs=0)


def test_engine_cap_default_is_four():
    _, cfg, _, p = _both("qwen2-0.5b")
    eng = Engine(cfg, p, ServeConfig(max_batch=1, max_seq=32))
    assert eng.max_prefill_graphs == 4
    for n in (4, 5, 6, 7, 8, 4):
        eng.prefill(torch.zeros((1, n), dtype=torch.long))
    assert list(eng.compiled_counts()["prefill"]) == [6, 7, 8, 4]
    assert eng.compiled_counts()["prefill_evictions"] == 2


def test_point_callable_value_runs_only_when_enabled():
    calls = []
    tp.point("p", lambda: calls.append(1) or torch.tensor(1.0))
    assert calls == []
    with tp.enable("tape"):
        _, tape = tp.collect(lambda: tp.point("p", lambda: calls.append(1) or 2.0))()
    assert calls == [1] and float(tape["p"][0]) == 2.0
    assert not tp.tracing_enabled()
    with pytest.raises(ValueError):
        with tp.enable("trace"):
            pass


def test_rmsnorm_attach_leaves_outputs_unchanged():
    _, cfg, _, p = _both("qwen2-0.5b")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, cfg.d_model),
                                                                  np.float32))
    want = nn_core.rmsnorm(p["final_norm"], x)
    with uprobes.ProbeRegistry(EventLog()) as reg:
        reg.attach(nn_core, "rmsnorm")
        reg.attach(nn_core, "rmsnorm")  # a second attach is a no-op
        got = nn_core.rmsnorm(p["final_norm"], x)
    assert torch.equal(got, want)
    assert dataclasses.is_dataclass(uprobes.op_site(torch.ops.aten.mm.default))
