"""The port's kernel autotuner (``repro_torch.tune``) on the CPU.

The counterparts of ``tests/test_tune.py`` that are not TPU-specific, held
against the JAX package where both compute the same thing (a synthetic
sweep's summary, winners, ``tune`` events and store JSON on the same
spaces with the same chip numbers; ``winners_from_store`` and ``show``;
the plain tier's tuned chunk), and the port's own Hopper space: each
default point is today's launch plan, feasibility refuses points past the
card's launch limits, the knobs reach the kernel wrappers, and the drivers'
``--tune`` flags, through the fleet.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.events import EventLog as JaxEventLog  # noqa: E402
from repro.dispatch.profiles import ProfileStore as JaxProfileStore  # noqa: E402
from repro.hw.specs import default_chip as jax_default_chip  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.tune import Explorer as JaxExplorer  # noqa: E402
from repro.tune import SweepSettings as JaxSweepSettings  # noqa: E402
from repro.tune import cli as jax_cli  # noqa: E402
from repro.tune import space as jax_space  # noqa: E402
from repro.tune import winners_from_store as jax_winners_from_store  # noqa: E402

from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.dispatch.profiles import ProfileStore  # noqa: E402
from repro_torch.hw.specs import H100_SXM  # noqa: E402
from repro_torch.kernels import ops, plan  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.tune import (Explorer, RooflinePruner, SweepSettings, apply_winners,  # noqa: E402
                              default_spaces, driver_tune, winners_from_store)
from repro_torch.tune import cli as tune_cli  # noqa: E402
from repro_torch.tune import explore  # noqa: E402
from repro_torch.tune import space as port_space  # noqa: E402

JAX_SCAN_KEYS = ("rwkv6_scan/chunked", "mamba_scan/chunked")


@pytest.fixture(autouse=True)
def _no_tuned_configs():
    yield
    ops.clear_tuned_configs()
    jax_ops.clear_tuned_configs()


# ---------------------------------------------------------------------------
# Against the JAX package: the same spaces, the same chip numbers
# ---------------------------------------------------------------------------


def _port_copy(js) -> port_space.KernelSpace:
    """The port's KernelSpace of a JAX chunked-scan space: the same grid,
    defaults, constraints, workload, key and cost formula (the port's
    ``scan_cost``, the JAX ``_scan_cost``), the JAX tier's factors."""
    return port_space.KernelSpace(
        op=js.op, backend=js.backend, impl=js.impl, grid=dict(js.grid),
        defaults=dict(js.defaults), align=dict(js.align), divides=dict(js.divides),
        workload=dict(js.workload), sig=js.sig,
        cost=functools.partial(port_space.scan_cost,
                               state_cols="V" if js.op == "rwkv6_scan" else "N"),
        tier=jax_space._TIER[js.backend],
    )


def _pair_spaces():
    jax_all = jax_space.default_spaces()
    js = {k: jax_all[k] for k in JAX_SCAN_KEYS}
    return js, {k: _port_copy(s) for k, s in js.items()}


def _port_chip():
    """The port's chip with the JAX default chip's name and the numbers its
    roofline prices with."""
    jc = jax_default_chip()
    return dataclasses.replace(H100_SXM, name=jc.name, peak_flops_f32=jc.peak_flops_f32,
                               hbm_bw=jc.hbm_bw)


def _tune_payloads(log) -> list:
    return [e.payload for e in log.events(kind="tune")]


@pytest.mark.parametrize("workers", [0, 2])
def test_synthetic_sweep_matches_the_jax_package(workers):
    """A synthetic sweep of the JAX package's two chunked-scan spaces and of
    the port's copies of them: the same points, summary, winners, ``tune``
    event payloads, and the saved ProfileStore JSON byte for byte."""
    js, ps = _pair_spaces()
    for k in JAX_SCAN_KEYS:
        assert [p.config for p in ps[k].points(_port_chip())] == [p.config for p in js[k].points()]
    jstore, jlog = JaxProfileStore(), JaxEventLog()
    jsum = JaxExplorer(jstore, spaces=js, log=jlog,
                       settings=JaxSweepSettings(mode="synthetic", workers=workers)).sweep()
    pstore, plog = ProfileStore(), EventLog()
    psum = Explorer(pstore, chip=_port_chip(), spaces=ps, log=plog,
                    settings=SweepSettings(mode="synthetic", workers=workers)).sweep()
    assert jsum["sweep_points"] > 0 and jsum["pruned"] > 0
    assert psum == jsum
    assert _tune_payloads(plog) == _tune_payloads(jlog)
    assert pstore.to_json() == jstore.to_json()


def test_winners_and_show_match_the_jax_package(tmp_path, capsys, monkeypatch):
    js, ps = _pair_spaces()
    jstore = JaxProfileStore()
    JaxExplorer(jstore, spaces=js, log=JaxEventLog(),
                settings=JaxSweepSettings(mode="synthetic")).sweep()
    path = tmp_path / "tuned.json"
    path.write_text(jstore.to_json())
    pstore = ProfileStore.from_json(path.read_text())
    assert winners_from_store(pstore, ps) == jax_winners_from_store(jstore, js)
    monkeypatch.setattr(jax_cli, "default_spaces", lambda: js)
    monkeypatch.setattr(tune_cli, "default_spaces", lambda: ps)
    for extra in ([], ["--json"]):
        assert jax_cli.main(["show", "--profile-in", str(path), *extra]) == 0
        want = capsys.readouterr().out
        assert tune_cli.main(["show", "--profile-in", str(path), *extra]) == 0
        assert capsys.readouterr().out == want and "chunk=" in want


def _scan_inputs(op: str, T: int):
    rng = np.random.default_rng(71)
    if op == "rwkv6_scan":
        B, H, K = 2, 2, 8
        r, k, v = (rng.standard_normal((B, T, H, K), np.float32) for _ in range(3))
        w = np.exp(-np.exp(rng.standard_normal((B, T, H, K)) * 0.5)).astype(np.float32)
        u = rng.standard_normal((H, K), np.float32) * 0.5
        s0 = rng.standard_normal((B, H, K, K), np.float32) * 0.1
        return [r, k, v, w, u, s0]
    B, DI, N = 2, 12, 4
    x = rng.standard_normal((B, T, DI), np.float32)
    dt = (0.01 + 0.1 * np.abs(rng.standard_normal((B, T, DI)))).astype(np.float32)
    A = (-0.1 - np.abs(rng.standard_normal((DI, N)))).astype(np.float32)
    Bm, C = (rng.standard_normal((B, T, N), np.float32) for _ in range(2))
    D = rng.standard_normal((DI,), np.float32)
    s0 = rng.standard_normal((B, DI, N), np.float32) * 0.1
    return [x, dt, A, Bm, C, D, s0]


@pytest.mark.parametrize("op", ["rwkv6_scan", "mamba_scan"])
@pytest.mark.parametrize("T,caller,tuned,used", [(64, 32, 16, 16), (48, 16, 32, 16)])
def test_plain_chunk_override_matches_the_jax_package(op, T, caller, tuned, used):
    """The plain tier's tuned chunk under ``tuned_scope``, in f32, against
    ``repro.kernels.ops`` with ``impl="chunked"`` under the same override:
    a chunk that divides T replaces the caller's, one that does not (32 of
    48) leaves it (``_scan_chunk``), in both packages."""
    arrays = _scan_inputs(op, T)
    tx = [torch.from_numpy(a) for a in arrays]
    jx = [jnp.asarray(a) for a in arrays]
    with ops.tuned_scope({op: {"plain": {"chunk": tuned}}}):
        assert ops._scan_chunk(op, "plain", caller, T) == used
        assert ops._scan_chunk(op, "kernel", caller, T) == caller  # another tier's knob
        got = getattr(ops, op)(*tx, chunk=caller)
    with jax_ops.tuned_scope({op: {"chunked": {"chunk": tuned}}}):
        assert jax_ops._scan_chunk(op, "chunked", caller, T) == used
        want = getattr(jax_ops, op)(*jx, chunk=caller, impl="chunked")
    tol = dict(atol=3e-5, rtol=3e-5) if op == "rwkv6_scan" else dict(atol=2e-5, rtol=2e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **tol)
    # the override is what ran: the port's chunked form at the used chunk
    ref_chunked = getattr(ops._ref, f"{op}_chunked")
    for g, w in zip(got, ref_chunked(*tx, chunk=used)):
        torch.testing.assert_close(g, w)


# ---------------------------------------------------------------------------
# The Hopper space
# ---------------------------------------------------------------------------

# every served shape of PERF.md §6 and the plan that shipped before the
# knobs: K2 (B, Hkv, S) -> (n_split, chunk); K4 (E, C, F) -> (row_tiles,
# row_blocks); K6 (B, H, K, V) -> vb, on 132 SMs
K2_SERVED = {
    "qwen2-0.5b": ((8, 2, 1024), (32, 32)),
    "deepseek-moe-16b": ((8, 16, 1024), (4, 320)),
    "jamba-1.5-large / chameleon-34b": ((8, 8, 1024), (6, 192)),
    "musicgen-large": ((8, 32, 1024), (2, 512)),
    "dbrx-132b": ((8, 8, 1024), (6, 192)),
    "gemma3-4b global": ((8, 4, 2048), (10, 224)),
    "gemma3-4b local": ((8, 4, 1024), (11, 96)),
    "gemma2-27b": ((8, 16, 1024), (4, 320)),
}
K4_SERVED = {
    "deepseek prefill": ((64, 64, 1408), (4, 1)),
    "deepseek decode": ((64, 8, 1408), (1, 1)),
    "jamba prefill": ((16, 80, 24576), (5, 1)),
    "jamba decode": ((16, 8, 24576), (1, 1)),
    "dbrx prefill": ((16, 160, 10752), (5, 2)),
    "dbrx decode": ((16, 8, 10752), (1, 1)),
}
K6_SERVED = {"rwkv6-7b prefill": ((1, 64, 64, 64), 16), "batch 8": ((8, 64, 64, 64), 64)}


@pytest.mark.parametrize("name", sorted(K2_SERVED))
def test_split_plan_default_is_todays_plan(name):
    (B, Hkv, S), want = K2_SERVED[name]
    assert plan.split_plan(B, Hkv, S, 132) == want
    assert plan.split_plan(B, Hkv, S, 132, waves=plan.WAVES) == want


@pytest.mark.parametrize("name", sorted(K4_SERVED))
def test_tile_plan_default_is_todays_plan(name):
    (E, C, F), want = K4_SERVED[name]
    p = plan.tile_plan(E, C, F)
    assert (p.row_tiles, p.row_blocks) == want
    assert p == plan.tile_plan(E, C, F, plan.MAX_ROW_TILES)
    assert p.row_tiles <= 8  # the default launches only the instances it launched before
    # the cap of 10 puts dbrx's 160 rows in one block (10 row tiles)
    if C == 160:
        q = plan.tile_plan(E, C, F, 10)
        assert (q.row_tiles, q.row_blocks) == (10, 1) and q.smem_bytes == 227328


@pytest.mark.parametrize("name", sorted(K6_SERVED))
def test_scan_plan_default_is_todays_plan(name):
    (B, H, K, V), want = K6_SERVED[name]
    p = plan.scan_plan(B, H, K, V, 132)
    assert p.vb == want
    assert plan.scan_plan(B, H, K, V, 132, column_tile=want) == p
    with pytest.raises(ValueError, match="column_tile"):
        plan.scan_plan(B, H, 8, V, 132, column_tile=16)  # K 8: 16 columns are half a warp


def test_space_defaults_are_the_shipped_values():
    spaces = default_spaces()
    assert set(spaces) == {"decode_attention/kernel", "moe_gmm/kernel", "rwkv6_scan/kernel",
                           "rwkv6_scan/plain", "mamba_scan/plain"}
    assert dict(spaces["decode_attention/kernel"].defaults) == {"waves": plan.WAVES}
    assert dict(spaces["moe_gmm/kernel"].defaults) == {"max_row_tiles": plan.MAX_ROW_TILES}
    assert dict(spaces["rwkv6_scan/kernel"].defaults) == {
        "column_tile": plan.scan_plan(1, 64, 64, 64, H100_SXM.sm_count).vb}
    # the plain tier's defaults are ops' own
    assert dict(spaces["rwkv6_scan/plain"].defaults) == {"chunk": 32}
    assert dict(spaces["mamba_scan/plain"].defaults) == {"chunk": 128}
    for space in spaces.values():
        assert space.default_config in [p.config for p in space.points()]
        # every point of the shipped grids fits the H100
        assert len(space.points()) == len(list(space.grid.values())[0])


def test_feasible_refuses_points_past_the_launch_limits():
    spaces = default_spaces()
    gmm, rwkv = spaces["moe_gmm/kernel"], spaces["rwkv6_scan/kernel"]
    assert gmm.feasible({"max_row_tiles": 10})
    assert not gmm.feasible({"max_row_tiles": 11})  # no instance past kMaxRowTiles
    # 227328 bytes of shared memory at 10 row tiles, 218112 at 9
    small = dataclasses.replace(H100_SXM, smem_block_bytes=220000)
    assert gmm.feasible({"max_row_tiles": 8}, small)
    assert not gmm.feasible({"max_row_tiles": 10}, small)
    assert gmm.plan({"max_row_tiles": 10}).smem_bytes == 227328 <= H100_SXM.smem_block_bytes
    # threads a block: 64 columns of head dim 64 take 256 threads
    few = dataclasses.replace(H100_SXM, threads_per_block=128)
    assert rwkv.feasible({"column_tile": 32}, few) and not rwkv.feasible({"column_tile": 64}, few)
    assert [p.config for p in rwkv.points(few)] == ["column_tile=16", "column_tile=32"]
    # ptxas: a spilling instance, or registers x threads past an SM's 65536
    spill = {"gmm_mma<10>": {"registers": 255, "spill_bytes": 24}}
    assert not gmm.feasible({"max_row_tiles": 10}, ptxas=spill)
    fits = {"gmm_mma<10>": {"registers": 255, "spill_bytes": 0}}
    assert gmm.feasible({"max_row_tiles": 10}, ptxas=fits)
    half = dataclasses.replace(H100_SXM, regs_per_sm=32768)
    assert not gmm.feasible({"max_row_tiles": 10}, half, ptxas=fits)
    assert "max_row_tiles=10" not in [p.config for p in gmm.points(ptxas=spill)]
    # the plain tier: divisibility and alignment, as in the JAX package
    mamba = spaces["mamba_scan/plain"]
    assert not mamba.feasible({"chunk": 12}) and not mamba.feasible({"chunk": 24})


def test_pruner_never_drops_the_default():
    for space in default_spaces().values():
        for ratio in (1.0, 4.0):
            kept, _ = RooflinePruner(ratio=ratio).prune(space, space.points())
            assert space.default_config in [p.config for p in kept], (space.key, ratio)


def test_synthetic_surface_deterministic_and_bounded():
    for space in default_spaces().values():
        for p in space.points():
            s = space.synthetic_s(p.params)
            assert s == space.synthetic_s(p.params)
            assert space.roofline_s(p.params) <= s <= space.roofline_s(p.params) * 1.05


@pytest.mark.parametrize("op,tier,knob,value,target", [
    ("decode_attention", "kernel", "waves", 4, "_decode_kernel"),
    ("moe_gmm", "kernel", "max_row_tiles", 10, "_gmm_kernel"),
    ("rwkv6_scan", "kernel", "column_tile", 64, "_rwkv6_kernel"),
])
def test_kernel_knobs_reach_the_wrappers(monkeypatch, op, tier, knob, value, target):
    """``tuned_overrides(op, "kernel")`` reaches the wrapper's knob (the
    wrapper itself runs its plain version for these CPU tensors)."""
    seen = {}
    real = getattr(ops, target)

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, target, spy)
    g = torch.Generator().manual_seed(0)
    if op == "decode_attention":
        args = (torch.randn(2, 4, 16, generator=g), torch.randn(2, 32, 2, 16, generator=g),
                torch.randn(2, 32, 2, 16, generator=g),
                torch.arange(32, dtype=torch.int32).expand(2, 32).contiguous(),
                torch.full((2,), 31, dtype=torch.int32))
        call = lambda: ops.decode_attention(*args)  # noqa: E731
    elif op == "moe_gmm":
        x, w = torch.randn(2, 8, 16, generator=g), torch.randn(2, 16, 24, generator=g)
        call = lambda: ops.gmm(x, w)  # noqa: E731
    else:
        arrays = [torch.from_numpy(a) for a in _scan_inputs("rwkv6_scan", 32)]
        call = lambda: ops.rwkv6_scan(*arrays)  # noqa: E731
    want = call()
    assert knob not in seen
    with ops.tuned_scope({op: {tier: {knob: value}}}):
        got = call()
    assert seen[knob] == value
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b)


# ---------------------------------------------------------------------------
# The Explorer on the port's spaces
# ---------------------------------------------------------------------------


def _sweep(store, workers=0, ops_filter=None, log=None, mode="synthetic", spaces=None, ptxas=None):
    return Explorer(store, log=log if log is not None else EventLog(), spaces=spaces,
                    settings=SweepSettings(mode=mode, workers=workers), ptxas=ptxas
                    ).sweep(ops_filter)


def test_synthetic_sweep_deterministic_across_worker_counts():
    s0, s2 = ProfileStore(), ProfileStore()
    r0, r2 = _sweep(s0, workers=0), _sweep(s2, workers=2)
    assert r0["sweep_points"] == r2["sweep_points"] > 0 and r0["spaces"] == 5
    assert s0.to_json() == s2.to_json()
    assert r0["winners"] == r2["winners"]
    for win in r0["winners"].values():
        assert win["speedup"] >= 1.0 and win["best_s"] <= win["default_s"]


def test_sweep_skips_warm_points_and_emits_tune_events():
    from repro_torch.metrics import MetricsPlane
    from repro_torch.trace.collector import TraceCollector

    log = TraceCollector()
    plane = MetricsPlane(log)
    store = ProfileStore()
    r1 = _sweep(store, log=log)
    assert r1["pruned"] >= 1 and r1["skipped_warm"] == 0
    tune_events = log.events(kind="tune")
    assert len([e for e in tune_events if e.payload.get("pruned") is True]) == r1["pruned"]
    assert len([e for e in tune_events if e.payload.get("pruned") is False]) == r1["sweep_points"]
    assert len([e for e in tune_events if e.payload.get("winner")]) == len(r1["winners"]) == 5
    assert len(log.events(name="tune_run")) == 2  # lifecycle enter / exit
    text = plane.registry.render()
    assert 'repro_tune_points_total{op="rwkv6_scan",pruned="true"}' in text
    assert 'repro_tune_points_total{op="moe_gmm",pruned="false"}' in text
    assert 'repro_tune_best_speedup{op="moe_gmm"}' in text
    r2 = _sweep(store)
    assert r2["sweep_points"] == 0 and r2["skipped_warm"] == r1["sweep_points"]


def _tiny(space, **workload):
    """A default space at a CPU-sized workload (the same op and tier)."""
    w = {**space.workload, **workload}
    if space.op == "rwkv6_scan":
        B, T, H, K, V = (w[k] for k in "BTHKV")
        inputs = ((space.inputs[0][0], (B, T, H, K)),) * 2 + ((space.inputs[2][0], (B, T, H, V)),
                  ("float32", (B, T, H, K)), ("float32", (H, K)), ("float32", (B, H, K, V)))
    else:
        B, T, DI, N = (w[k] for k in ("B", "T", "DI", "N"))
        inputs = (("float32", (B, T, DI)), ("float32", (B, T, DI)), ("float32", (DI, N)),
                  ("float32", (B, T, N)), ("float32", (B, T, N)), ("float32", (DI,)),
                  ("float32", (B, DI, N)))
    return dataclasses.replace(space, workload=w, inputs=inputs,
                               sig=port_space._sig(*inputs))


def test_interpret_sweep_measures_plain_spaces_only():
    """On the CPU an interpret sweep runs the plain versions and publishes
    no kernel winner."""
    d = default_spaces()
    spaces = {"rwkv6_scan/kernel": _tiny(d["rwkv6_scan/kernel"], T=32, H=2),
              "rwkv6_scan/plain": _tiny(d["rwkv6_scan/plain"], T=32, H=2, K=8, V=8),
              "mamba_scan/plain": _tiny(d["mamba_scan/plain"], T=64, DI=16)}
    store = ProfileStore()
    summary = _sweep(store, mode="interpret", spaces=spaces)
    assert summary["spaces"] == 2 and summary["sweep_points"] > 0
    assert set(summary["winners"]) == {"rwkv6_scan/plain", "mamba_scan/plain"}
    table, _ = winners_from_store(store, spaces)
    assert "kernel" not in table.get("rwkv6_scan", {})


def test_a_point_that_fails_its_check_never_wins(monkeypatch):
    """A real point that disagrees with the plain version gets no sample and
    a ``failed`` tune event; the rest compete (timings faked: no card)."""
    space = default_spaces()["moe_gmm/kernel"]

    def fake(space_, chip, params, mode, warmup, repeats):
        if params["max_row_tiles"] == 10:
            return [], {"rel_err": 0.5, "tol": explore.CHECK_TOL, "ok": False}
        return [1e-3 * params["max_row_tiles"]] * repeats, {"rel_err": 1e-3,
                                                             "tol": explore.CHECK_TOL,
                                                             "ok": True}

    monkeypatch.setattr(explore, "_measure", fake)
    log, store = EventLog(), ProfileStore()
    summary = _sweep(store, log=log, mode="real", spaces={space.key: space}, ptxas={})
    assert summary["failed"] == 1
    failed = [e.payload for e in log.events(kind="tune") if e.payload.get("failed")]
    assert [p["config"] for p in failed] == ["max_row_tiles=10"]
    assert store.samples(space.op, space.backend, space.sig, "max_row_tiles=10") == 0
    assert summary["winners"][space.key]["config"] == "max_row_tiles=2"


def test_winners_apply_and_driver_tune_cached():
    from repro_torch.dispatch import DispatchConfig, Dispatcher, host_registry

    d = Dispatcher(DispatchConfig(policy="profiled"), registry=host_registry(device="cpu"),
                   log=EventLog())
    _sweep(d.store)  # a previous run or a fleet pull filled the store
    table, details = winners_from_store(d.store)
    assert set(details) == set(default_spaces())
    assert apply_winners(table) == sum(len(v) for v in table.values())
    ops.clear_tuned_configs()
    rec = driver_tune("cached", d, d.log)
    assert rec["sweep_points"] == 0 and "winners" not in rec and rec["applied"] >= 1
    for op, impls in rec["configs"].items():
        for tier, config in impls.items():
            assert ops.active_config(op, tier) == config
    assert ops.config_tag("kernel") and "moe_gmm:max_row_tiles=" in ops.config_tag("kernel")


def test_real_sweep_with_workers_is_refused():
    with pytest.raises(ValueError, match="R16"):
        SweepSettings(mode="real", workers=2)
    SweepSettings(mode="interpret", workers=2)
    SweepSettings(mode="synthetic", workers=2)


def test_cli_spaces_and_sweep(tmp_path, capsys):
    assert tune_cli.main(["spaces", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["space"] for r in rows["spaces"]] == sorted(default_spaces())
    gmm = next(r for r in rows["spaces"] if r["space"] == "moe_gmm/kernel")
    assert {p["config"]: p["instance"] for p in gmm["points"]}["max_row_tiles=10"] == \
        "gmm_mma<10>"
    assert "flash_attention/chunked" in rows["not_swept"]
    out = tmp_path / "tuned.json"
    fleet = tmp_path / "fleet"
    assert tune_cli.main(["sweep", "--mode", "synthetic", "--fleet", str(fleet),
                          "--out", str(out), "--json"]) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["sweep_points"] > 0 and first["fleet"]["push"]["pushed"]
    assert tune_cli.main(["sweep", "--mode", "synthetic", "--fleet", str(fleet), "--json"]) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["sweep_points"] == 0 and second["fleet"]["match"] == "exact"
    assert second["winners"] == first["winners"]
    assert tune_cli.main(["sweep", "--mode", "real", "--workers", "1"]) == 1
    assert "R16" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

SERVE = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "2",
         "--max-new", "3"]


def test_tune_requires_dispatch(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main([*SERVE, "--tune", "cached"])
    assert exc.value.code == 2 and "--tune requires --dispatch" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                        "--tune", "sweep"])
    assert exc.value.code == 2


def test_real_workers_refused_by_the_argument_check(capsys):
    """On a CUDA device a real sweep with workers is refused before any
    work (so before the card is asked for: there is none here)."""
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "qwen2-0.5b", "--device", "cuda", "--dispatch", "profiled",
                        "--tune", "sweep", "--tune-workers", "2"])  # real: cuda's default
    assert exc.value.code == 2 and "R16" in capsys.readouterr().err


def test_serve_tune_sweep_then_cached_through_the_fleet(tmp_path):
    fleet = str(tmp_path / "fleet")
    base = [*SERVE, "--dispatch", "profiled", "--fleet", fleet]
    first = serve_cli.main([*base, "--tune", "sweep", "--tune-mode", "synthetic"])
    ops.clear_tuned_configs()
    assert first["tune"]["sweep_points"] > 0 and first["tune"]["applied"] >= 1
    assert first["fleet"]["push"]["pushed_samples"] > 0
    cached = serve_cli.main([*base, "--tune", "cached"])
    ops.clear_tuned_configs()
    assert cached["tune"]["sweep_points"] == 0
    assert cached["tune"]["configs"] == first["tune"]["configs"]
    assert cached["fleet"]["pull"]["match"] == "exact"
    again = serve_cli.main([*base, "--tune", "sweep", "--tune-mode", "synthetic"])
    assert again["tune"]["sweep_points"] == 0 and again["tune"]["skipped_warm"] > 0
    assert cached["sample"] == first["sample"]


def test_train_tune_cached_and_fleet(tmp_path):
    fleet = str(tmp_path / "fleet")
    serve_cli.main([*SERVE, "--dispatch", "profiled", "--fleet", fleet, "--tune", "sweep",
                    "--tune-mode", "synthetic"])
    ops.clear_tuned_configs()
    rec = train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps",
                          "3", "--batch", "2", "--seq", "16", "--ckpt-every", "0",
                          "--dispatch", "profiled", "--fleet", fleet, "--tune", "cached"])
    assert rec["tune"]["sweep_points"] == 0 and rec["tune"]["applied"] >= 1
    assert rec["fleet"]["pull"]["match"] == "exact"
    assert rec["fleet"]["push"]["pushed_samples"] > 0


_NO_TORCH = r"""
import json, sys
sys.modules["torch"] = None  # import torch now raises ImportError
sys.modules["numpy"] = None
from repro_torch.tune import cli
assert cli.main(["spaces"]) == 0
assert cli.main(["sweep", "--mode", "synthetic", "--out", sys.argv[1]]) == 0
"""


def test_spaces_and_a_synthetic_sweep_run_without_torch(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = tmp_path / "tuned.json"
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, str(out)], capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": str(src)}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "moe_gmm/kernel" in proc.stdout and "not swept" in proc.stdout
    assert len(ProfileStore.from_json(out.read_text())) > 0
