"""The port's profile-guided dispatch (``repro_torch.dispatch``) on the CPU.

Every case of ``tests/test_dispatch.py`` on the port's two targets
(``kernel``, the Hopper kernels; ``plain``, ``kernels/ref.py``), the
engine, supervisor and drivers under a dispatcher, and the port held
against the JAX package where both compute the same thing: the signature
of a call, the profile store's JSON in both directions, and the
dispatcher's sequence of choices given the same samples and estimates.

The kernel tier needs CUDA tensors, so the CPU engines switch between two
targets of the plain impl: a switch of tier between ticks must leave every
request's tokens as the undispatched engine's.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.events import EventLog as JaxEventLog  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.dispatch import Dispatcher as JaxDispatcher  # noqa: E402
from repro.dispatch import ProfileStore as JaxProfileStore  # noqa: E402
from repro.dispatch import signature as jax_signature  # noqa: E402
from repro.dispatch.registry import BackendRegistry as JaxBackendRegistry  # noqa: E402
from repro.dispatch.registry import BackendTarget as JaxBackendTarget  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import scopes, sdfg  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.core.overhead import stats_from_samples  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.dispatch import (  # noqa: E402
    BackendRegistry,
    BackendTarget,
    DispatchConfig,
    Dispatcher,
    ProfileStore,
    default_registry,
    estimate_callable,
    estimate_region,
    estimate_sdfg,
    host_registry,
    signature,
    with_impl,
)
from repro_torch.dispatch.cost import estimate_run, total_seconds  # noqa: E402
from repro_torch.hw.specs import H100_SXM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.supervisor import FailureInjector, Supervisor, SupervisorConfig  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.trace.session import age_out_profiles, git_sha, load_profile_stores  # noqa: E402
from repro_torch.training.optim import leaves  # noqa: E402
from repro_torch.training.step import TrainConfig, init_train_state, make_train_step  # noqa: E402

TARGETS = ["kernel", "plain"]


def _region(name: str, flops: float, bytes_: float, component: str = sdfg.TENSOR_CORE):
    r = sdfg.Region(name)
    r.flops = flops
    r.bytes = bytes_
    r.nodes = 1
    r.backends[component] = flops if component == sdfg.TENSOR_CORE else bytes_
    return r


def _two_plain_tiers() -> BackendRegistry:
    """Two targets of the plain impl: switching between them on the CPU is
    switching between two sets of compiled steps."""
    reg = BackendRegistry()
    reg.register(BackendTarget("a", "plain", launch_overhead_s=1e-6))
    reg.register(BackendTarget("b", "plain", launch_overhead_s=2e-6))
    return reg


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("component", [sdfg.TENSOR_CORE, sdfg.CUDA_CORE, sdfg.HBM])
def test_cost_monotone_in_work(target, component):
    """Bigger region (more flops AND more bytes) => cost never decreases."""
    t = default_registry().get(target)
    small = _region("s", 1e9, 1e6, component)
    for mult in (2.0, 10.0, 1000.0):
        big = _region("b", 1e9 * mult, 1e6 * mult, component)
        assert (estimate_region(big, t, H100_SXM).seconds
                >= estimate_region(small, t, H100_SXM).seconds)


@pytest.mark.parametrize("target", TARGETS)
def test_cost_positive_and_has_launch_floor(target):
    t = default_registry().get(target)
    e = estimate_region(_region("e", 0.0, 0.0), t, H100_SXM)
    assert e.seconds >= t.launch_overhead_s > 0
    assert e.t_collective == 0.0 and e.t_host == 0.0


def test_roofline_prefers_the_kernels_large_and_tiny():
    """Large regions price the kernel tier cheapest (the plain versions
    move 7.34x the bytes at a fraction of the tensor-core rate).  The JAX
    package's tiny-region crossover to its reference tier does not carry
    over: the cited factors put a plain call's floor (K3's plain version at
    (8, 896), 0.0292 ms) above the kernels' (K3's launch floor, 0.0050),
    as PERF.md §6 finds every plain version slower than its kernel even at
    qwen2's decode shapes.  So tiny regions price the kernel tier cheapest
    too."""
    disp = Dispatcher(DispatchConfig(policy="roofline"), registry=default_registry(),
                      log=EventLog())
    for flops, nbytes in ((1e3, 1e3), (1e12, 1e9), (0.0, 5e8)):
        ests = {b: e.seconds for b, e in disp.estimates_for_region(
            _region("r", flops, nbytes)).items()}
        assert min(ests, key=ests.get) == "kernel"
    tiny = {b: e.seconds for b, e in disp.estimates_for_region(_region("t", 1e3, 1e3)).items()}
    assert tiny["plain"] / tiny["kernel"] == pytest.approx(2.92e-5 / 5.0e-6, rel=1e-3)


def test_pricing_splits_tensor_core_and_f32_work():
    """Tensor-core FLOPs at the bf16 peak, every other FLOP at the f32 peak
    (core/roofline.py's split), bytes at the HBM rate, host-link bytes at
    the PCIe rate, NVLink bytes at the card's total link rate."""
    t = BackendTarget("unit", "plain", flop_efficiency={}, launch_overhead_s=0.0)
    r = sdfg.Region("r", flops=3e12, bytes=0.0)
    r.backends[sdfg.TENSOR_CORE] = 2e12
    e = estimate_region(r, t, H100_SXM)
    assert e.t_compute == pytest.approx(2e12 / 989e12 + 1e12 / 67e12)
    r2 = sdfg.Region("r2", bytes=6.7e9)
    r2.backends[sdfg.HOST] = 6.4e9
    r2.backends[sdfg.NVLINK] = 4.5e9
    e2 = estimate_region(r2, t, H100_SXM)
    assert e2.t_memory == pytest.approx(2e-3)
    assert e2.t_host == pytest.approx(0.1)
    assert e2.t_collective == pytest.approx(4.5e9 / (25e9 * 18))
    assert e2.seconds == pytest.approx(2e-3 + 0.1 + 0.01)
    assert e2.bottleneck == "host"


def test_estimate_callable_prices_aten_ops_at_their_bound_in_both_tiers():
    """On the CPU a run launches no kernel: every node is an aten op, the
    same in either tier, priced at its roofline bound, so both tiers price
    it alike; the per-region estimates (the tier's factors on everything)
    do not."""
    a, b = torch.ones(64, 128), torch.ones(128, 32)

    def f(a, b):
        with scopes.scope("mm"):
            c = a @ b
        with scopes.scope("norm"):
            return c / (1e-6 + c.abs().mean())

    g = sdfg.extract(f, a, b)
    ests = {t: estimate_callable(f, a, b, target=default_registry().get(t), chip=H100_SXM)
            for t in TARGETS}
    assert ests["kernel"].seconds == ests["plain"].seconds > 0
    assert ests["plain"].t_memory == pytest.approx(sum(n.bytes for n in g.nodes) / 3.35e12)
    assert ests["plain"].t_compute == pytest.approx(sum(n.flops for n in g.nodes) / 67e12)
    per = estimate_sdfg(g, default_registry().get("plain"), H100_SXM)
    assert set(per) == {"mm", "norm"}
    assert total_seconds(per) > ests["plain"].seconds


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "rmsnorm",
                                    "moe_gmm", "rwkv6_scan", "mamba_scan",
                                    "flash_attention_bwd", "rmsnorm_bwd",
                                    "decode_attention_stats", "moe_gmm_bwd"])
def test_estimate_run_prices_each_kernel_by_its_tier(kernel):
    """A run's kernel launch costs the tier's launch overhead plus its bound
    over the tier's efficiency on that kernel, and the plain tier prices
    every kernel above the kernel tier (PERF.md §6: every plain version is
    slower than its kernel), while the aten op beside it prices alike."""
    from repro_torch.kernels import LAUNCHES

    assert kernel in LAUNCHES
    reg = default_registry()
    nodes = [sdfg.Node(0, "mm", sdfg.TENSOR_CORE, 2e9, 4e6, "r", product=True),
             sdfg.Node(1, kernel, sdfg.CUDA_CORE, 1e6, 8e6, "r", kernel=True)]
    g = sdfg.SDFG(nodes, [])
    est = {t: estimate_run(g, reg.get(t), H100_SXM) for t in TARGETS}
    aten = max(2e9 / 989e12, 4e6 / 3.35e12)
    for t in TARGETS:
        target = reg.get(t)
        bound = max(1e6 / 67e12, 8e6 / 3.35e12)
        want = aten + target.launch_overhead_s + bound / target.kernel_efficiency[kernel]
        assert est[t].seconds == pytest.approx(want)
    assert est["plain"].seconds > est["kernel"].seconds
    # a kernel the table lacks takes its component's efficiency
    odd = sdfg.SDFG([sdfg.Node(0, "new_kernel", sdfg.HBM, 0.0, 8e6, "r", kernel=True)], [])
    for t in TARGETS:
        target = reg.get(t)
        assert estimate_run(odd, target, H100_SXM).seconds == pytest.approx(
            target.launch_overhead_s + 8e6 / 3.35e12 / target.efficiency(sdfg.HBM))


# ---------------------------------------------------------------------------
# profile store
# ---------------------------------------------------------------------------


def test_measured_overrides_estimate():
    store = ProfileStore(min_samples=2)
    assert store.combined_cost("op", "plain", "s", 1.0) == (1.0, "roofline")
    store.record("op", "plain", "s", 5.0)
    assert store.combined_cost("op", "plain", "s", 1.0) == (1.0, "roofline")
    store.record("op", "plain", "s", 7.0)
    assert store.combined_cost("op", "plain", "s", 1.0) == (5.0, "measured")


def test_profile_flips_dispatch_decision():
    """Roofline says kernel; warm measurements say plain — the dispatcher
    follows the measurements."""
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                      registry=default_registry(), log=EventLog())
    disp.store.record("op", "kernel", "sig", 0.5)
    disp.store.record("op", "plain", "sig", 0.01)
    d = disp.choose("op", "sig", {"kernel": 1e-6, "plain": 1e-3})
    assert d.backend == "plain" and d.source == "measured"


def test_profile_store_json_roundtrip_and_timing_stats():
    store = ProfileStore(min_samples=3)
    for v in (1.0, 2.0, 3.0):
        store.record("op", "plain", "s", v)
    store.observe_timing("op", "kernel", "s", stats_from_samples("k", [2.0, 4.0, 3.0]))
    clone = ProfileStore.from_json(store.to_json())
    assert clone.min_samples == 3
    assert clone.lookup("op", "plain", "s") == store.lookup("op", "plain", "s") == 1.0
    assert clone.samples("op", "kernel", "s") == 3
    assert clone.lookup("op", "kernel", "s") == pytest.approx(2e-3)


def test_ingest_event_log_rehydrates_profiles():
    log = EventLog()
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                      registry=_two_plain_tiers(), log=log)
    fns = {"a": lambda x: x * 2, "b": lambda x: x + x}
    for _ in range(4):
        disp.dispatch("toy", fns, torch.ones(8))
    fresh = ProfileStore(min_samples=1)
    assert fresh.ingest_event_log(log) == 4
    sig = signature(torch.ones(8))
    assert sig == "float32[8]"
    assert fresh.samples("toy", "a", sig) + fresh.samples("toy", "b", sig) == 4


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", TARGETS)
def test_static_policy_pins_backend(backend):
    disp = Dispatcher(DispatchConfig(policy="static", static_backend=backend),
                      registry=default_registry(), log=EventLog())
    for _ in range(3):
        d = disp.choose("op", "s", {"kernel": 1.0, "plain": 0.001})
        assert d.backend == backend and d.source == "static"


def test_static_kernel_on_a_cpu_registry_falls_back_and_says_so():
    disp = Dispatcher(DispatchConfig(policy="static", static_backend="kernel"),
                      registry=host_registry(device="cpu"), log=EventLog())
    d = disp.choose("op", "s", {"plain": 1.0})
    assert d.backend == "plain" and d.source == "static-fallback"


def test_profiled_explores_every_candidate_then_exploits():
    log = EventLog()
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=2),
                      registry=_two_plain_tiers(), log=log)
    fns = {"a": lambda x: x * 2, "b": lambda x: x + x}
    for _ in range(6):
        disp.dispatch("toy", fns, torch.ones(16))
    by_backend = disp.summary()["by_op"]["toy"]
    assert set(by_backend) == {"a", "b"} and all(v >= 2 for v in by_backend.values())
    # the tie of no samples goes to the cheaper estimate, then the least sampled
    assert [d.backend for d in disp.decisions[:4]] == ["a", "b", "a", "b"]
    assert disp.decisions[-1].source == "measured"
    events = log.events(kind="dispatch")
    assert len(events) == 6 == disp.summary()["decisions"]
    assert all(isinstance(e.payload["measured_s"], float) for e in events)
    # the explored calls per tier, apart from the settled ones
    assert disp.summary()["explore_by_op"] == {"toy": {"a": 2, "b": 2}}


def test_a_call_on_the_cpu_is_timed_on_the_hosts_clock():
    """Only a call whose outputs lie on the card is timed with CUDA events;
    a CPU call's sample is the host's time around it."""
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                      registry=_two_plain_tiers(), log=EventLog())

    def slow(x):
        time.sleep(0.02)
        return x

    disp.dispatch("toy", {"a": slow}, torch.ones(4))
    assert disp.decisions[-1].measured_s >= 0.02


def test_dispatch_catches_no_failure():
    """A variant that raises raises through dispatch(): no other tier runs."""
    disp = Dispatcher(DispatchConfig(policy="static", static_backend="a"),
                      registry=_two_plain_tiers(), log=EventLog())
    ran = []

    def broken(x):
        raise RuntimeError("kernel failed to launch")

    with pytest.raises(RuntimeError, match="failed to launch"):
        disp.dispatch("toy", {"a": broken, "b": lambda x: ran.append(x)}, torch.ones(2))
    assert ran == []


def test_dispatcher_stamps_its_samples_with_the_card():
    disp = Dispatcher(DispatchConfig(), registry=default_registry(), log=EventLog())
    disp.dispatch("toy", {"plain": lambda x: x}, torch.ones(2))
    entry = disp.store.entry("toy", "plain", "float32[2]")
    assert entry.chip == "h100_sxm" == disp.chip.name
    assert entry.git_sha == git_sha()


def test_partition_assigns_every_region_and_logs():
    def f(a, b):
        with scopes.scope("mm"):
            c = a @ b
        with scopes.scope("norm"):
            return c / (1e-6 + torch.mean(torch.abs(c)))

    g = sdfg.extract(f, torch.ones(128, 256, dtype=torch.bfloat16),
                     torch.ones(256, 128, dtype=torch.bfloat16))
    log = EventLog()
    disp = Dispatcher(DispatchConfig(policy="roofline"), registry=default_registry(), log=log)
    placement = disp.partition(g)
    assert set(placement) == set(g.regions()) == {"mm", "norm"}
    assert all(d.backend in TARGETS for d in placement.values())
    assert len(log.events(kind="dispatch")) == len(placement)


def test_with_impl_binds_the_impl_at_call_time():
    """``plain`` records no kernel note, ``auto`` on the CPU records the
    plain ops one by one (the same sequence), the process default comes
    back after the call, and a later impl_scope outside does not leak in."""
    x = torch.randn(4, 8, 2, 16)

    def f(q):
        return ops.attention(q, q, q, causal=True) + ops.rmsnorm(q, torch.zeros(16))

    plain, auto = with_impl("plain", f), with_impl("auto", f)
    with ops.impl_scope("kernel"):  # would raise on CPU tensors if it leaked in
        g_plain = sdfg.extract(plain, x)
    g_auto = sdfg.extract(auto, x)
    assert not any(n.kernel for n in g_plain.nodes + g_auto.nodes)
    assert [n.primitive for n in g_plain.nodes] == [n.primitive for n in g_auto.nodes]
    assert ops._IMPL == "auto"
    assert plain.__name__ == "f__plain"


def test_host_registry_follows_the_device():
    """The kernel tier only for a CUDA device: a CPU engine never gets a
    variant that raises."""
    assert host_registry(device="cpu").names() == ["plain"]
    assert host_registry(device="cuda").names() == TARGETS
    assert host_registry(device=torch.device("cuda", 0)).names() == TARGETS
    with pytest.raises(ValueError, match="CUDA"):
        with_impl("kernel", lambda x: ops.rmsnorm(x, torch.zeros(8)))(torch.ones(2, 8))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def test_signature_equals_jax():
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "ids": rng.integers(0, 9, (4, 7)).astype(np.int32)}
    jt = {"w": jnp.asarray(arrs["w"], jnp.bfloat16), "b": jnp.asarray(arrs["b"]),
          "ids": jnp.asarray(arrs["ids"])}
    tt = {"w": torch.from_numpy(arrs["w"]).to(torch.bfloat16), "b": torch.from_numpy(arrs["b"]),
          "ids": torch.from_numpy(arrs["ids"])}
    assert signature(tt) == jax_signature(jt) == "float32[5];int32[4,7];bfloat16[2,3]"
    assert signature(tt["w"], [tt["b"]], 3) == jax_signature(jt["w"], [jt["b"]], 3)
    assert signature(1.0) == jax_signature(1.0) == "<scalar>"
    big_t = [torch.zeros(i + 1, 3) for i in range(40)]
    big_j = [jnp.zeros((i + 1, 3)) for i in range(40)]
    assert signature(big_t) == jax_signature(big_j)
    assert signature(big_t).startswith("tree:40leaves:")


def _filled(cls):
    store = cls(min_samples=3)
    store.set_stamp(git_sha="abc1234", chip="h100_sxm")
    for i, v in enumerate((3e-3, 2e-3, 4e-3)):
        store.record("serve_decode", "kernel", "int64[8]", v)
        store.record("serve_decode", "plain", "int64[8]", 2 * v + i * 1e-4)
    store.record("train_step", "kernel", "int32[4,2048];int32[4,2048]", 0.164,
                 config="k=1")
    return store


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_profile_store_loads_in_the_other_package(direction):
    src_cls, dst_cls = ((ProfileStore, JaxProfileStore) if direction == "port_to_jax"
                        else (JaxProfileStore, ProfileStore))
    src = _filled(src_cls)
    text = src.to_json()
    assert text == _filled(dst_cls).to_json()  # byte for byte the same JSON
    dst = dst_cls.from_json(text)
    assert dst.min_samples == src.min_samples and len(dst) == len(src)
    for backend in TARGETS:
        key = ("serve_decode", backend, "int64[8]")
        assert dst.lookup(*key) == src.lookup(*key)
        assert dst.samples(*key) == src.samples(*key) == 3
        e, f = dst.entry(*key), src.entry(*key)
        assert (e.mean_s, e.m2, e.git_sha, e.chip) == (f.mean_s, f.m2, f.git_sha, f.chip)
    assert dst.samples("train_step", "kernel", "int32[4,2048];int32[4,2048]", "k=1") == 1


def _jax_registry():
    reg = JaxBackendRegistry()
    reg.register(JaxBackendTarget("kernel", "chunked"))
    reg.register(JaxBackendTarget("plain", "ref"))
    return reg


@pytest.mark.parametrize("policy", ["static", "roofline", "profiled"])
def test_choose_sequence_equals_jax(policy):
    """The same target names, samples and estimates: the two dispatchers
    make the same sequence of (backend, source)."""
    port = Dispatcher(DispatchConfig(policy=policy, static_backend="plain", min_samples=3),
                      registry=default_registry(), log=EventLog())
    jaxd = JaxDispatcher(JaxDispatchConfig(policy=policy, static_backend="plain",
                                           min_samples=3),
                         registry=_jax_registry(), log=JaxEventLog())
    ests = {"kernel": 2e-3, "plain": 1e-3}  # the model's guess is wrong
    times = {"kernel": [9e-3, 4e-3, 3e-3, 3e-3], "plain": [8e-3, 7e-3, 6e-3, 6e-3]}
    seq = {"port": [], "jax": []}
    for i in range(12):
        for name, d in (("port", port), ("jax", jaxd)):
            dec = d.choose("serve_decode", "int64[8]", ests)
            seq[name].append((dec.backend, dec.source))
            n = d.store.samples("serve_decode", dec.backend, "int64[8]")
            d.store.record("serve_decode", dec.backend, "int64[8]",
                           times[dec.backend][min(n, 3)])
    assert seq["port"] == seq["jax"]
    if policy == "profiled":
        assert [b for b, _ in seq["port"][:6]] == ["plain", "kernel"] * 3
        assert seq["port"][-1] == ("kernel", "measured")


def test_a_tpu_store_written_by_jax_ages_out_whole(tmp_path):
    jstore = JaxProfileStore(min_samples=2)
    jstore.set_stamp(git_sha=git_sha(), chip="tpu_v5e")
    for backend in ("pallas", "chunked", "ref"):
        jstore.record("serve_decode", backend, "int32[8]", 1e-3)
    path = tmp_path / "tpu.json"
    path.write_text(jstore.to_json())
    store = load_profile_stores([str(path)])
    aged = age_out_profiles(store, H100_SXM.name)
    assert len(aged) == 3 and len(store) == 0
    assert all("tpu_v5e -> h100_sxm" in a["reason"] for a in aged)


# ---------------------------------------------------------------------------
# the engine under dispatch
# ---------------------------------------------------------------------------


def _serve(cfg, params, prompts, disp=None, compiled=True, max_new=6, **kw):
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=64), log=EventLog(),
                 compiled=compiled, dispatcher=disp, **kw)
    rids = [eng.submit(pr, max_new=max_new) for pr in prompts]
    res = eng.run_to_completion()
    return [res[r] for r in rids], eng


def _noisy(tree, gen, std=0.3):
    """Every float leaf plus seeded noise: a random init's greedy tokens
    barely depend on the context (the flat-init RWKV6 and Mamba leaves
    above all), and these must."""
    if isinstance(tree, dict):
        return {k: _noisy(v, gen, std) for k, v in tree.items()}
    if not tree.is_floating_point():
        return tree
    return tree + std * torch.randn(tree.shape, generator=gen).to(tree.dtype)


def _prompts(vocab, n=5, length=16, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


@pytest.mark.parametrize("policy", ["roofline", "profiled"])
@pytest.mark.parametrize("compiled", [True, False])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b", "jamba-1.5-large"])
def test_engine_dispatched_matches_undispatched(arch, compiled, policy):
    """Tiers switching between ticks (profiled, min_samples 1) and pricing
    (an extract run of each surface) leave every request's tokens as the
    undispatched engine's: pricing must not advance the recurrent states
    (RWKV6 wkv / shift, Mamba ssm / conv) of the served requests."""
    cfg = reduced(get_config(arch))
    params = _noisy(lm.init_params(cfg, 0, device="cpu"), torch.Generator().manual_seed(7))
    prompts = _prompts(cfg.vocab_size)
    base, _ = _serve(cfg, params, prompts, compiled=compiled)
    assert len({tuple(b) for b in base}) == len(prompts)  # the context matters
    log = EventLog()
    disp = Dispatcher(DispatchConfig(policy=policy, min_samples=1),
                      registry=_two_plain_tiers(), log=log)
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=64), log=log,
                 compiled=compiled, dispatcher=disp)
    rids = [eng.submit(pr, max_new=6) for pr in prompts]
    res = eng.run_to_completion()
    assert [res[r] for r in rids] == base
    by_op = disp.summary()["by_op"]
    assert set(by_op) == {"serve_prefill", "serve_decode"}
    if policy == "profiled":  # both tiers ran each surface
        assert all(set(v) == {"a", "b"} for v in by_op.values())
    events = log.events(kind="dispatch")
    assert len(events) == disp.summary()["decisions"]
    assert all("measured_s" in e.payload for e in events)
    # every dispatch event is the child of its request's prefill or a tick
    brackets = {e.span for e in log.events(kind="spawn")
                if e.name in ("prefill", "decode_tick")}
    assert all(e.parent in brackets for e in events)


def test_engine_dispatched_matches_the_jax_dispatched_engine():
    """qwen2-0.5b under a profiled dispatcher in both packages (the JAX one
    over its host tiers, chunked and ref; the port's over two plain tiers):
    the same tokens, and the same decisions per surface."""
    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-0.5b"))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jlog = JaxEventLog()
    jdisp = JaxDispatcher(JaxDispatchConfig(policy="profiled", min_samples=1), log=jlog)
    jeng = JaxEngine(jcfg, jp, JaxServeConfig(max_batch=2, max_seq=64), log=jlog,
                     dispatcher=jdisp)
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                      registry=_two_plain_tiers(), log=EventLog())
    prompts = _prompts(cfg.vocab_size, n=4, length=8)
    for pr in prompts:
        jeng.submit(pr, max_new=5)
    want = jeng.run_to_completion()
    got, _ = _serve(cfg, p, prompts, disp, max_new=5)
    assert got == [want[r] for r in sorted(want)]
    count = {s["policy"]: {op: sum(v.values()) for op, v in s["by_op"].items()}
             for s in (disp.summary(), jdisp.summary())}
    assert len(count) == 1  # same policy, same decisions per surface


def test_dispatched_prefill_graphs_respect_the_cap():
    """max_prefill_graphs counts (target, prompt length) graphs: 2 tiers x
    3 lengths under a cap of 4 evict the least recently used pairs."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (8, 8, 12, 12, 16, 16)]
    base, _ = _serve(cfg, params, prompts, max_new=4)
    disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                      registry=_two_plain_tiers(), log=EventLog())
    got, eng = _serve(cfg, params, prompts, disp, max_new=4, max_prefill_graphs=4)
    assert got == base
    counts = eng.compiled_counts()
    kept = sum(len(v) for v in counts["prefill"].values())
    assert kept == 4 and counts["prefill_evictions"] == 2
    assert set(counts["decode"]) == {"a", "b"}
    assert sum(c["calls"] for c in counts["decode"].values()) == disp.summary()["by_op"][
        "serve_decode"]["a"] + disp.summary()["by_op"]["serve_decode"]["b"]


def test_cpu_engine_gets_no_kernel_variant():
    """A CPU engine under the full registry builds the plain tier only, and
    static kernel falls back to it, saying so in every event."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg.vocab_size, n=2, length=8)
    base, _ = _serve(cfg, params, prompts, max_new=3)
    disp = Dispatcher(DispatchConfig(policy="static", static_backend="kernel"),
                      registry=default_registry(), log=EventLog())
    got, eng = _serve(cfg, params, prompts, disp, max_new=3)
    assert got == base
    assert set(eng.compiled_counts()["decode"]) == {"plain"}
    assert {d.source for d in disp.decisions} == {"static-fallback"}


# ---------------------------------------------------------------------------
# the supervisor and the drivers
# ---------------------------------------------------------------------------


def test_supervisor_dispatched_run_matches_undispatched(tmp_path):
    """Each step routed between two tiers (each its own step over the same
    state), one injected failure: the losses and the final state of the
    undispatched run of the same impl, bit for bit, and every step's
    decision under its step's span.  (Under ``auto`` on the CPU the
    attention backward is ``ref.flash_attention_bwd_ref`` inside
    ``ops.Attention``, under ``plain`` torch autograd through ``mha_ref``:
    their gradients differ in the last bits.)"""
    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=5))

    def batch_fn(i):
        return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}

    def run(dispatched, d):
        state = init_train_state(cfg, tcfg, 0, "cpu")
        log = EventLog()
        disp = variants = None
        if dispatched:
            disp = Dispatcher(DispatchConfig(policy="profiled", min_samples=1),
                              registry=_two_plain_tiers(), log=log)
            variants = {t.name: with_impl(t.impl, make_train_step(cfg, tcfg))
                        for t in disp.registry.targets()}
        sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / d), ckpt_every=3, max_steps=7),
                         with_impl("plain", make_train_step(cfg, tcfg)), batch_fn, state, log=log,
                         failures=FailureInjector((5,)), dispatcher=disp,
                         step_variants=variants)
        return sup.run(), sup, disp, log

    out_a, sup_a, _, _ = run(False, "a")
    out_b, sup_b, disp, log = run(True, "b")
    assert out_b["restarts"] == 1 and out_b["steps"] == 7
    assert [m["loss"] for m in out_b["metrics"]] == [m["loss"] for m in out_a["metrics"]]
    for x, y in zip(leaves(sup_a.state), leaves(sup_b.state)):
        assert torch.equal(x, y)
    assert set(disp.summary()["by_op"]["train_step"]) == {"a", "b"}
    events = log.events(kind="dispatch")
    steps = {e.span for e in log.events(kind="spawn", name="step")}
    assert len(events) == 7 + 2 and all(e.parent in steps for e in events)


def test_serve_driver_dispatch_and_warm_start(tmp_path, capsys):
    out = tmp_path / "p.json"
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "4",
            "--max-new", "4", "--dispatch", "profiled"]
    cold = serve_cli.main(argv + ["--profile-out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == cold
    assert cold["dispatch"]["by_op"] == {"serve_prefill": {"plain": 4},
                                         "serve_decode": {"plain": 3}}
    assert cold["dispatch_events"] == cold["dispatch"]["decisions"] == 7
    assert cold["dispatch"]["explore_dispatches"] == 4  # 2 samples each surface
    assert cold["profile_out"] == str(out)
    # a TPU store from the JAX package rides along and ages out whole
    tpu = JaxProfileStore()
    tpu.set_stamp(git_sha="0000000", chip="tpu_v5e")
    tpu.record("serve_decode", "chunked", "int32[4]", 1e-3)
    tpu.record("serve_prefill", "pallas", "int32[1,16]", 1e-3)
    (tmp_path / "tpu.json").write_text(tpu.to_json())
    warm = serve_cli.main(argv + ["--profile-in", str(out), "--profile-in",
                                  str(tmp_path / "tpu.json")])
    capsys.readouterr()
    assert warm["dispatch"]["explore_dispatches"] == 0
    assert warm["profile_aged_out"] == 2
    assert warm["profile_in"] == [str(out), str(tmp_path / "tpu.json")]
    assert warm["sample"] == cold["sample"]


def test_serve_driver_without_dispatch_prints_no_dispatch_fields(capsys):
    rec = serve_cli.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                          "--requests", "2", "--max-new", "3"])
    capsys.readouterr()
    assert "dispatch" not in rec and "profile_out" not in rec


def test_train_driver_dispatch_and_warm_start(tmp_path, capsys):
    out = tmp_path / "p.json"
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "5",
            "--batch", "2", "--seq", "16", "--dispatch", "profiled"]
    plain = train_cli.main(argv[:-2] + ["--fail-at", "3", "--ckpt-dir", str(tmp_path / "a")])
    cold = train_cli.main(argv + ["--fail-at", "3", "--ckpt-dir", str(tmp_path / "b"),
                                  "--profile-out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == cold
    assert cold["dispatch"]["by_op"] == {"train_step": {"plain": 5 + 3}}
    assert cold["restarts"] == 1 and cold["losses"] == plain["losses"]
    assert cold["step_backends"] == ["plain"] * 5
    assert cold["compiled"] == {"plain": {"calls": 8, "captures": 0, "replays": 0}}
    warm = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "c"), "--profile-in", str(out)])
    capsys.readouterr()
    assert warm["dispatch"]["explore_dispatches"] == 0 and warm["profile_aged_out"] == 0
    assert warm["losses"] == cold["losses"]
