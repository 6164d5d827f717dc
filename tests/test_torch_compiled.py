"""The port's compiled steps (``serving/compiled.py``) on the CPU.

On the card the engine replays CUDA graphs; a graph freezes every value the
host computed while it was captured, reads and writes the addresses it saw,
and launches kernels without calling their wrappers.  These tests hold the
parts of that which the CPU can show:

1. a capture-safety trace: the aten ops of ``decode_step`` and ``prefill``,
   with their non-tensor arguments and their tensors' shapes and dtypes,
   do not depend on the token and position values, and none forces a
   device-to-host sync; nor do the train step's, at other step counts;
2. every cache leaf of ``Engine.caches`` keeps its storage across decode
   ticks and prefills' copies into their slots;
3. launch accounting: a capture adds no launches, N replays add N times
   the captured counts (``kernels.uncounted`` / ``kernels.add_launches``),
   and ``CompiledStep`` does so across eager call, capture and replays;
4. ``Engine(compiled=True)`` on a CPU device (static buffers feeding eager
   calls) gives the tokens of ``Engine(compiled=False)``.

``tests/test_torch_serving.py`` holds the default (compiled) engine against
the JAX engine and the JAX model's own decode loop.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import compiled  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.training.optim import leaves  # noqa: E402
from repro_torch.training.step import TrainConfig, init_train_state, make_train_step  # noqa: E402

ARCHS = ["qwen2-0.5b", "deepseek-moe-16b", "rwkv6-7b", "jamba-1.5-large", "gemma2-27b",
         "gemma3-4b", "chameleon-34b", "musicgen-large"]
# ops that read tensor data on the host: each forces a device-to-host sync
# on the card, which a CUDA graph's capture refuses
SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique",
            "aten._unique", "aten.is_nonzero", "aten.equal")
MAX_SEQ = 32
PROMPT_LEN = 8  # within the reduced RWKV6 / Mamba scan chunk of 16


def _model(arch):
    cfg = reduced(get_config(arch))
    return cfg, lm.init_params(cfg, 0, device="cpu")


class _OpTrace(TorchDispatchMode):
    """Each aten op with its non-tensor arguments and its tensors' shapes
    and dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def describe(a):
            if isinstance(a, torch.Tensor):
                return ("tensor", tuple(a.shape), a.dtype)
            return repr(a)

        self.ops.append((str(func), tree_map(describe, (args, kwargs))))
        return func(*args, **kwargs)


def _trace(fn):
    with _OpTrace() as t:
        fn()
    return t.ops


def _sync_ops(ops):
    found = [name for name, _ in ops if name.startswith(SYNC_OPS)]
    # repeat_interleave with a repeats tensor reads its sum on the host
    found += [name for name, _ in ops
              if name.startswith("aten.repeat_interleave") and not name.endswith("self_int")]
    # a boolean mask as an index (on the CPU its nonzero runs inside the op)
    found += [name for name, (args, _) in ops
              if name.startswith(("aten.index", "aten._index_put")) and len(args) > 1
              and isinstance(args[1], (list, tuple))
              and any(isinstance(i, tuple) and i[2] == torch.bool for i in args[1])]
    return found


def _assert_same_trace(a, b):
    assert len(a) == len(b), f"{len(a)} ops against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"op {i} differs between the two calls:\n{x}\n{y}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_trace_is_capture_safe(arch):
    """Two decode steps that differ only in their token and position values
    dispatch the same ops with the same non-tensor arguments (a graph would
    freeze any value that made them differ), and neither syncs."""
    cfg, params = _model(arch)
    calls = (([3, 200], [PROMPT_LEN, 11]), ([17, 5], [20, PROMPT_LEN + 1]))
    traces = []
    for toks, pos in calls:
        caches = lm.init_caches(cfg, 2, MAX_SEQ, "cpu")
        tokens = torch.tensor(toks, dtype=torch.long)
        positions = torch.tensor(pos, dtype=torch.int32)
        traces.append(_trace(lambda: lm.decode_step(params, cfg, tokens, positions, caches)))
    assert traces[0], "nothing was traced"
    assert _sync_ops(traces[0]) == [] and _sync_ops(traces[1]) == []
    _assert_same_trace(*traces)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_trace_is_capture_safe(microbatches):
    """Train steps at other step counts (warmup steps 1, 2 and 7) on other
    tokens dispatch the same ops with the same non-tensor arguments (the
    schedule and the bias corrections come from the step tensor on the
    device, not from host numbers a graph would freeze), and none syncs;
    with 2 microbatches too (the accumulation loop a graph captures
    unrolled)."""
    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig(microbatches=microbatches)
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(5)
    traces = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        traces.append(_trace(lambda: step(state, batch)))
        if len(traces) == 2:
            state["opt"]["step"].add_(4)
    assert int(state["opt"]["step"]) == 7
    assert all(_sync_ops(t) == [] for t in traces)
    _assert_same_trace(traces[0], traces[1])
    _assert_same_trace(traces[0], traces[2])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_moe_train_step_trace_is_capture_safe_and_counts_k4b(monkeypatch, microbatches):
    """deepseek-moe-16b's train step (a dense layer and three MoE layers,
    remat "nothing"), as CompiledTrainStep captures it: at other step
    counts on other tokens it dispatches the same ops with the same
    non-tensor arguments and none syncs (the routing's sort, capacity
    cumsum and gathers included), and each step calls K4b's wrappers five
    times a MoE layer (the gated dgrad, the dgrad and three wgrads) and
    K4's three times a MoE layer's forward run (twice under remat) and once
    in its backward (the pre-activation), the launches a replay repeats on
    the card."""
    import dataclasses

    from repro_torch.kernels import moe_gmm, ops

    calls = {"moe_gmm": 0, "moe_gmm_bwd": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "_gmm_kernel", counted("moe_gmm", ops._gmm_kernel))
    for attr in ("gated_dgrad", "dgrad", "wgrad"):
        monkeypatch.setattr(moe_gmm, attr, counted("moe_gmm_bwd", getattr(moe_gmm, attr)))
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), n_layers=4,
                              remat_policy="nothing")
    n_moe = sum(cfg.layer_spec(i).ffn == "moe" for i in range(cfg.n_layers))
    tcfg = TrainConfig(microbatches=microbatches)
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(6)
    traces = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        before = dict(calls)
        traces.append(_trace(lambda: step(state, batch)))
        assert calls["moe_gmm_bwd"] - before["moe_gmm_bwd"] == 5 * n_moe * microbatches
        assert calls["moe_gmm"] - before["moe_gmm"] == (2 * 3 + 1) * n_moe * microbatches
        if len(traces) == 2:
            state["opt"]["step"].add_(4)
    assert n_moe == 3 and all(_sync_ops(t) == [] for t in traces)
    _assert_same_trace(traces[0], traces[1])
    _assert_same_trace(traces[0], traces[2])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-large"])
def test_train_step_with_frontend_embed_trace_is_capture_safe(arch, microbatches):
    """As above for a frontend arch's step with embeddings (the compiled
    step's third static input, split with the tokens over microbatches):
    other embeddings and tokens at other step counts dispatch the same ops,
    and none syncs."""
    cfg = reduced(get_config(arch))
    tcfg = TrainConfig(microbatches=microbatches)
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(6)
    traces = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        fe = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frontend_embed": fe}
        traces.append(_trace(lambda: step(state, batch)))
        if len(traces) == 2:
            state["opt"]["step"].add_(4)
    assert all(_sync_ops(t) == [] for t in traces)
    _assert_same_trace(traces[0], traces[1])
    _assert_same_trace(traces[0], traces[2])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-large"])
def test_compiled_train_step_with_frontend_embed_matches_eager(arch, microbatches):
    """CompiledTrainStep with frontend embeddings (eager through its static
    buffers on the CPU) equals make_train_step's step bit for bit: each
    step's metrics and every leaf of the state after three steps from
    states of the same seed; the embeddings reach the loss."""
    from repro_torch.training.compiled import CompiledTrainStep

    cfg = reduced(get_config(arch))
    tcfg = TrainConfig(microbatches=microbatches)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        fe = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], "frontend_embed": fe})
    eager_state = init_train_state(cfg, tcfg, 0, "cpu")
    eager = make_train_step(cfg, tcfg)
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = CompiledTrainStep(cfg, tcfg, state)
    for batch in batches:
        _, want = eager(eager_state, batch)
        _, got = step(state, batch)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert step.counts() == {"calls": 3, "captures": 0, "replays": 0}
    for a, b in zip(leaves(state), leaves(eager_state)):
        assert torch.equal(a, b)
    # without the embeddings the step is another one
    bare_state = init_train_state(cfg, tcfg, 0, "cpu")
    _, bare = make_train_step(cfg, tcfg)(
        bare_state, {k: v for k, v in batches[0].items() if k != "frontend_embed"})
    first_state = init_train_state(cfg, tcfg, 0, "cpu")
    _, first = make_train_step(cfg, tcfg)(first_state, batches[0])
    assert float(bare["loss"]) != float(first["loss"])


def test_compiled_train_step_with_frontend_embed_refuses_a_batch_without():
    """A step built with embeddings (its first call) refuses a batch
    without them, and keeps their static buffer's shape."""
    from repro_torch.training.compiled import CompiledTrainStep

    cfg = reduced(get_config("chameleon-34b"))
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = CompiledTrainStep(cfg, tcfg, state)
    toks = torch.zeros(2, 8, dtype=torch.long)
    fe = torch.zeros(2, 8, cfg.d_model)
    step(state, {"tokens": toks, "labels": toks, "frontend_embed": fe})
    with pytest.raises(ValueError, match="built for"):
        step(state, {"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match="built for"):
        step(state, {"tokens": toks, "labels": toks, "frontend_embed": fe[:, :4]})
    assert step.counts()["calls"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_trace_is_capture_safe(arch):
    """Two prefills of one length with other token values dispatch the same
    ops with the same non-tensor arguments, and neither syncs."""
    cfg, params = _model(arch)
    rng = np.random.default_rng(4)
    traces = []
    for _ in range(2):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT_LEN)))
        traces.append(_trace(lambda: lm.prefill(params, cfg, tokens, max_seq=MAX_SEQ)))
    assert _sync_ops(traces[0]) == [] and _sync_ops(traces[1]) == []
    _assert_same_trace(*traces)


def test_sync_ops_are_flagged():
    """The trace sees the syncs it looks for: a Python value taken from a
    tensor, a boolean mask, and repeats given as a tensor."""
    x = torch.arange(6)
    ops = _trace(lambda: (int(x[2]), x[x > 2], torch.repeat_interleave(x, x)))
    found = _sync_ops(ops)
    assert any(n.startswith("aten._local_scalar_dense") for n in found)
    assert any(n.startswith("aten.index.Tensor") for n in found)
    assert any(n.startswith("aten.repeat_interleave") for n in found)


def _leaf_ptrs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_ptrs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.data_ptr()}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_caches_keep_their_storage(arch):
    """Prefills copied into their slots and decode ticks write every cache
    leaf in place: a leaf rebound to a new tensor would leave a captured
    graph reading the old one."""
    cfg, params = _model(arch)
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=MAX_SEQ), log=EventLog())
    ptrs = _leaf_ptrs(eng.caches)
    rng = np.random.default_rng(2)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist(), max_new=3)
    ticks = 0
    while eng.pending():
        eng.step()
        ticks += 1
        assert _leaf_ptrs(eng.caches) == ptrs, f"a cache leaf moved in tick {ticks}"
    assert eng.compiled_counts()["decode"]["calls"] == ticks


@pytest.fixture
def launches():
    saved = kernels.launch_counts()
    kernels.reset_launches()
    yield kernels.LAUNCHES
    kernels.LAUNCHES.update(saved)


def test_capture_adds_no_launches_and_replays_add_the_captured_counts(launches):
    launches["rmsnorm"] = 5  # launches made before the capture
    with kernels.uncounted() as made:
        # what the wrappers count while a graph is captured
        launches["rmsnorm"] += 3
        launches["decode_attention"] += 2
    assert kernels.launch_counts() == {**dict.fromkeys(launches, 0), "rmsnorm": 5}
    assert made == {**dict.fromkeys(launches, 0), "rmsnorm": 3, "decode_attention": 2}
    for _ in range(4):  # four replays
        kernels.add_launches(made)
    kernels.add_launches(made, times=3)  # three more at once
    assert launches["rmsnorm"] == 5 + 7 * 3 and launches["decode_attention"] == 7 * 2
    assert launches["flash_attention"] == 0


def test_failed_capture_adds_no_launches(launches):
    with pytest.raises(RuntimeError, match="capture failed"):
        with kernels.uncounted():
            launches["moe_gmm"] += 3
            raise RuntimeError("capture failed")
    assert launches["moe_gmm"] == 0


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs
    what the capture recorded without calling ``fn`` (or any wrapper)."""

    def __init__(self):
        self.work = None

    def replay(self):
        self.work()


def _fake_card(monkeypatch):
    """torch.cuda's stream and graph entry points, as a CompiledStep calls
    them, for a step on the CPU that goes through eager call, capture and
    replays."""
    class Stream:
        def wait_stream(self, other):
            pass

    capture = {}

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        capture["graph"] = g
        yield
        capture["graph"] = None

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    graphs = compiled.Graphs(torch.device("cpu"))
    graphs.stream = Stream()
    return graphs, capture


def test_compiled_step_counts_eager_capture_and_replays(monkeypatch, launches):
    """First call eager (its launches counted), second captured (nothing
    counted) and replayed, later calls replayed: each replay adds the
    captured launches, so the total is what eager calls would have counted."""
    graphs, capture = _fake_card(monkeypatch)
    out = torch.zeros(3)

    def fn(x):  # x is the step's static buffer
        launches["rmsnorm"] += 2  # two wrapper calls
        launches["flash_attention"] += 1
        torch.mul(x, 2.0, out=out)
        if capture.get("graph") is not None:  # what the graph would record
            capture["graph"].work = lambda: torch.mul(x, 2.0, out=out)
        return out

    step = graphs.step(fn)
    results = [step(torch.full((3,), float(i))).clone() for i in range(5)]
    assert step.counts() == {"calls": 5, "captures": 1, "replays": 4}
    assert launches["rmsnorm"] == 2 * 5 and launches["flash_attention"] == 5
    assert step.launches == {**dict.fromkeys(launches, 0), "rmsnorm": 2, "flash_attention": 1}
    for i, r in enumerate(results):  # each call saw its own input through the static buffer
        torch.testing.assert_close(r, torch.full((3,), 2.0 * i))


def test_compiled_step_keeps_one_shape():
    """A step is built for one set of input shapes and dtypes (a graph per
    shape, as jax.jit keeps an executable per shape); its static buffers
    are reused."""
    step = compiled.Graphs(torch.device("cpu")).step(lambda x: x + 1)
    step(torch.zeros(2, 4))
    buf = step._static[0].data_ptr()
    torch.testing.assert_close(step(torch.ones(2, 4)), torch.full((2, 4), 2.0))
    assert step._static[0].data_ptr() == buf
    with pytest.raises(ValueError, match="built for"):
        step(torch.zeros(2, 5))
    with pytest.raises(ValueError, match="built for"):
        step(torch.zeros(2, 4, dtype=torch.float64))
    assert step.counts() == {"calls": 2, "captures": 0, "replays": 0}


def test_compiled_step_refuses_another_config_tag():
    """A step keeps the tuned configs' tags of its first call: a graph
    bakes their launch plans, so a call under another kernel or plain tag
    raises, and one under the same tags runs (tune/ installs winners before
    the steps are built)."""
    from repro_torch.kernels import ops

    step = compiled.Graphs(torch.device("cpu")).step(lambda x: x + 1)
    with ops.tuned_scope({"moe_gmm": {"kernel": {"max_row_tiles": 10}}}):
        step(torch.zeros(2))
        assert step.config_tags == ("moe_gmm:max_row_tiles=10", "")
        step(torch.zeros(2))
    with pytest.raises(RuntimeError, match="tuned configs"):
        step(torch.zeros(2))
    for table in ({"moe_gmm": {"kernel": {"max_row_tiles": 5}}},
                  {"moe_gmm": {"kernel": {"max_row_tiles": 10}},
                   "mamba_scan": {"plain": {"chunk": 64}}}):
        with ops.tuned_scope(table), pytest.raises(RuntimeError, match="tuned configs"):
            step(torch.zeros(2))
    assert step.counts()["calls"] == 2


def test_compiled_train_step_refuses_another_config_tag():
    from repro_torch.kernels import ops
    from repro_torch.training.compiled import CompiledTrainStep

    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, 0, "cpu")
    step = CompiledTrainStep(cfg, tcfg, state)
    toks = torch.zeros(2, 8, dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    step(state, batch)
    with ops.tuned_scope({"decode_attention": {"kernel": {"waves": 4}}}):
        with pytest.raises(RuntimeError, match="tuned configs"):
            step(state, batch)
    step(state, batch)
    assert step.counts()["calls"] == 2


def test_first_build_inside_a_capture_raises(monkeypatch):
    """A kernel's build, load and SM-count query belong in the eager call
    before a capture; inside one they raise instead of running."""
    def no_build(names=_build.SOURCES):
        raise AssertionError("nvcc must not run inside a capture")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_SM_COUNTS", {})
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        _build.load("rmsnorm")
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        _build.sm_count(0)
    _build._SM_COUNTS[0] = 132  # queried before the capture: no query now
    assert _build.sm_count(0) == 132


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_engine_on_cpu_matches_eager(arch):
    """Engine(compiled=True) on a CPU device runs eagerly through its static
    buffers and gives every request the tokens of Engine(compiled=False):
    5 requests through 2 slots, one prompt length."""
    cfg, params = _model(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist() for _ in range(5)]
    outs = {}
    for flag in (False, True):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=MAX_SEQ), log=EventLog(),
                     compiled=flag)
        rids = [eng.submit(pr, max_new=4) for pr in prompts]
        res = eng.run_to_completion()
        outs[flag] = [res[r] for r in rids]
        if flag:
            counts = eng.compiled_counts()
            assert counts["prefill"] == {PROMPT_LEN: {"calls": 5, "captures": 0, "replays": 0}}
            assert counts["decode"]["calls"] > 0 and counts["decode"]["captures"] == 0
        else:
            assert eng.compiled_counts() == {}
    assert outs[True] == outs[False]
    assert all(len(o) == 4 for o in outs[True])


def test_compiled_engine_sampling_stays_seeded():
    """Sampling stays outside the step, on the engine's own generator: at a
    temperature the compiled and eager engines draw the same stream."""
    cfg, params = _model("qwen2-0.5b")
    outs = []
    for flag in (False, True):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=MAX_SEQ, temperature=1.0,
                                              seed=3), log=EventLog(), compiled=flag)
        rids = [eng.submit([1, 2, 3, 4], max_new=6) for _ in range(3)]
        res = eng.run_to_completion()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
