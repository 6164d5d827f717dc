"""The port's driver around the train step on the CPU: the checkpoint store,
the supervisor and the compiled train step.

Mirrors ``tests/test_runtime.py`` (round trip, async writes with garbage
collection, atomic writes, restart determinism, giving up, stragglers, a
checkpoint restored onto a mesh; and ``Supervisor.resize`` off a 1 x 1
gloo mesh and back mid-run, equal to the run that never moved) and adds what the port must keep
across the two packages: a checkpoint the JAX store wrote, bf16 leaves
included, read bit for bit (ROADMAP R12); the same manifest as the JAX
store's; a snapshot that is a copy; a restore into the live tensors; the
compiled step (eager through its static buffers here) equal to the eager
one (``tests/test_torch_compiled.py`` holds its ops capture-safe); the
port's supervisor against the JAX supervisor from the same weights; and
the driver with an injected failure.
"""
import json
import os
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.runtime import supervisor as jax_sup  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_into,
    save,
)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.supervisor import (  # noqa: E402
    FailureInjector,
    NodeFailure,
    Supervisor,
    SupervisorConfig,
)
from repro_torch.training.compiled import CompiledTrainStep  # noqa: E402
from repro_torch.training.optim import leaves  # noqa: E402
from repro_torch.training.step import TrainConfig, init_train_state, make_train_step  # noqa: E402

# the training parity tolerance of tests/test_torch_training.py (f32 losses)
LOSS_TOL = 1e-5


def _mk(seed=0, params=None):
    """Reduced smollm-360m: a fresh state, the eager step and batch_fn."""
    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, seed, "cpu", params=params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=5))

    def batch_fn(i):
        return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}

    return cfg, tcfg, state, make_train_step(cfg, tcfg), batch_fn


def _bits(t):
    return t.detach().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_event_log_counts_what_its_ring_drops():
    log = EventLog(maxlen=3)
    for i in range(5):
        log.record("mark", "x", i)
    assert len(log) == 3 and log.dropped == 2 and log.maxlen == 3
    assert [e.payload for e in log.events()] == [2, 3, 4]
    log.clear()
    assert len(log) == 0 and log.dropped == 0
    assert EventLog().maxlen is None


def test_save_restore_roundtrip(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": {"c": torch.tensor(7, dtype=torch.int32)},
             "w": torch.randn(5, 3).to(torch.bfloat16)}
    save(str(tmp_path), 3, state)
    assert latest_step(str(tmp_path)) == 3
    got = restore(str(tmp_path), 3, {k: v for k, v in state.items()})
    assert list(got) == list(state) and got["a"] is not state["a"]
    torch.testing.assert_close(got["a"], state["a"], rtol=0, atol=0)
    c = got["b"]["c"]
    assert c.dtype == torch.int32 and c.shape == () and int(c) == 7
    assert got["w"].dtype == torch.bfloat16 and np.array_equal(_bits(got["w"]), _bits(state["w"]))
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 3, {**state, "a": torch.zeros(4, 3)})


def test_restore_into_keeps_the_storage(tmp_path):
    """``restore_into`` copies a checkpoint into the given tensors: the
    values ``restore`` gives, each leaf in its own storage and dtype."""
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": {"c": torch.tensor(7, dtype=torch.int32)},
             "w": torch.randn(5, 3).to(torch.bfloat16)}
    save(str(tmp_path), 3, state)
    want = restore(str(tmp_path), 3, state)
    live = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros((), dtype=torch.int32)},
            "w": torch.zeros(5, 3, dtype=torch.bfloat16)}
    ptrs = [t.data_ptr() for t in leaves(live)]
    restore_into(str(tmp_path), 3, live)
    assert [t.data_ptr() for t in leaves(live)] == ptrs
    for a, b in zip(leaves(live), leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="shape"):
        restore_into(str(tmp_path), 3, {**live, "a": torch.zeros(4, 3)})


def test_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((8,), float(s))})
    ck.wait()
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    got = restore(str(tmp_path), 4, {"x": torch.zeros(8)})
    torch.testing.assert_close(got["x"], torch.full((8,), 4.0), rtol=0, atol=0)


def test_atomic_write_no_partial_visible(tmp_path):
    save(str(tmp_path), 1, {"x": torch.zeros(4)})
    # a stale tmp dir from a killed writer is not a checkpoint
    os.makedirs(tmp_path / ".tmp_step_00000002")
    assert latest_step(str(tmp_path)) == 1


def test_async_save_snapshots_a_copy(tmp_path):
    """A save followed at once by an in-place step still writes the values
    before the step: on the CPU ``Tensor.cpu()`` is the live storage."""
    state = {"w": torch.arange(1 << 20, dtype=torch.float32),
             "s": torch.tensor(4, dtype=torch.int32)}
    before = {k: v.clone() for k, v in state.items()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    state["w"].add_(1.0)
    state["s"].add_(1)
    ck.wait()
    got = restore(str(tmp_path), 1, state)
    assert torch.equal(got["w"], before["w"]) and int(got["s"]) == 4


def test_reads_a_bf16_checkpoint_of_the_jax_store(tmp_path):
    """The JAX store writes bf16 as 2-byte voids (|V2) and cannot restore
    them (ROADMAP R12); the port reads f32, int32 and bf16 leaves of it bit
    for bit."""
    rng = np.random.default_rng(41)
    tree = {"a": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
            "b": {"c": jnp.int32(7), "w": jnp.asarray(rng.standard_normal((6, 5)), jnp.bfloat16)},
            "z": jnp.asarray(rng.standard_normal(9), jnp.bfloat16)}
    jax_ckpt.save(str(tmp_path), 2, tree)
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros((), dtype=torch.int32),
                                          "w": torch.zeros(6, 5, dtype=torch.bfloat16)},
            "z": torch.zeros(9, dtype=torch.bfloat16)}
    got = restore(str(tmp_path), 2, like)
    for key, want, t in (("a", tree["a"], got["a"]), ("b/c", tree["b"]["c"], got["b"]["c"]),
                         ("b/w", tree["b"]["w"], got["b"]["w"]), ("z", tree["z"], got["z"])):
        want = np.asarray(want)
        assert t.dtype == {"a": torch.float32, "b/c": torch.int32}.get(key, torch.bfloat16), key
        assert tuple(t.shape) == want.shape and _bits(t).tobytes() == want.tobytes(), key


def test_manifest_and_payload_match_the_jax_store(tmp_path):
    """For the same dict of arrays the port writes the JAX store's manifest,
    and the same bytes under each key."""
    rng = np.random.default_rng(42)
    arrays = {"opt": {"step": np.asarray(3, np.int32), "mu": rng.standard_normal((2, 3))
                      .astype(np.float32)},
              "params": {"zeta": rng.standard_normal(4).astype(jnp.bfloat16),
                         "alpha": rng.standard_normal((2, 2)).astype(np.float32)}}

    def to_torch(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jax_ckpt.save(str(jdir), 5, arrays)
    save(str(tdir), 5, jax.tree.map(to_torch, arrays))
    manifests = [json.loads((d / "step_00000005" / "manifest.json").read_text())
                 for d in (jdir, tdir)]
    assert manifests[0] == manifests[1]
    assert [leaf["dtype"] for leaf in manifests[1]["leaves"]] == ["float32", "int32", "float32",
                                                                  "bfloat16"]
    with np.load(jdir / "step_00000005" / "arrays.npz") as jz, \
            np.load(tdir / "step_00000005" / "arrays.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].tobytes() == tz[k].tobytes(), k


def test_supervisor_restart_is_deterministic(tmp_path):
    """The same data and a restored state: the run with a failure at step 7
    ends with the params of the run without one, bit for bit."""
    cfg, tcfg, state_a, step, batch_fn = _mk()
    _, _, state_b, _, _ = _mk()
    log = EventLog()
    sup_a = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=5, max_steps=12),
                       step, batch_fn, state_a, log=log)
    out_a = sup_a.run()
    sup_b = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=5, max_steps=12),
                       step, batch_fn, state_b, log=log, failures=FailureInjector((7,)))
    out_b = sup_b.run()
    assert out_a["restarts"] == 0 and out_b["restarts"] == 1
    assert out_a["steps"] == out_b["steps"] == 12
    assert len(out_b["metrics"]) == 12 + 2  # steps 5 and 6 ran twice
    assert [m["loss"] for m in out_b["metrics"][7:]] == [m["loss"] for m in out_a["metrics"][5:]]
    for a, b in zip(leaves(sup_a.state), leaves(sup_b.state)):
        assert torch.equal(a, b)
    assert int(sup_b.state["opt"]["step"]) == 12
    assert log.events("spawn", "restart") and out_b["trace"]["dropped"] == 0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    cfg, tcfg, state, step, batch_fn = _mk()
    sup = Supervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=100, max_steps=10, max_restarts=2),
        step, batch_fn, state, failures=FailureInjector((1, 2, 3, 4)),
    )
    # each restart goes back to step 0 and a fired step does not fire
    # again: with max_restarts=2 the 3rd failure raises
    with pytest.raises(NodeFailure):
        sup.run()
    assert sup.restarts == 3


def test_straggler_detection(tmp_path):
    cfg, tcfg, state, step, batch_fn = _mk()

    def slow_batch(i):
        if i == 15:  # an injected host-level straggle, past any deadline so far
            time.sleep(max(1.0, 2 * 3.0 * max(sup.durations)))
        return batch_fn(i)

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=100, max_steps=18,
                                      straggler_factor=3.0),
                     step, slow_batch, state, log=EventLog())
    out = sup.run()
    assert out["stragglers"] >= 1
    ev = sup.log.events("straggler")
    assert 15 in [e.payload["step"] for e in ev]  # a loaded host may add its own
    step_spans = {e.span for e in sup.log.events("spawn", "step")}
    assert all(e.parent in step_spans for e in ev)


def test_restart_restores_into_the_live_tensors(tmp_path):
    """A restart copies the checkpoint into the state's own tensors, the
    step counter too: every leaf keeps its storage (a captured step reads
    and writes those addresses)."""
    cfg, tcfg, state, step, batch_fn = _mk()
    ptrs = [t.data_ptr() for t in leaves(state)]
    seen = []

    def batch_at(i):
        seen.append((i, int(state["opt"]["step"])))
        return batch_fn(i)

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=3, max_steps=6),
                     step, batch_at, state, failures=FailureInjector((5,)))
    out = sup.run()
    assert out["restarts"] == 1
    assert all(a is b for a, b in zip(leaves(sup.state), leaves(state)))
    assert [t.data_ptr() for t in leaves(state)] == ptrs
    # the counter went back to 3 with the restore: each step saw its own count
    assert seen == [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (3, 3), (4, 4), (5, 5)]


def test_compiled_train_step_on_the_cpu_equals_the_eager_step():
    """On the CPU the compiled step runs the step eagerly through its static
    buffers: losses and every leaf equal the eager step's."""
    cfg, tcfg, state_c, step, batch_fn = _mk()
    _, _, state_e, _, _ = _mk()
    compiled = CompiledTrainStep(cfg, tcfg, state_c)
    for i in range(3):
        _, mc = compiled(state_c, batch_fn(i))
        _, me = step(state_e, batch_fn(i))
        assert set(mc) == set(me)
        for k in me:
            assert torch.equal(mc[k], me[k]), k
    for a, b in zip(leaves(state_c), leaves(state_e)):
        assert torch.equal(a, b)
    assert compiled.counts() == {"calls": 3, "captures": 0, "replays": 0}


def test_compiled_train_step_refuses_another_state():
    cfg, tcfg, state, step, batch_fn = _mk()
    compiled = CompiledTrainStep(cfg, tcfg, state)
    other = _mk()[2]  # equal values, other tensors
    with pytest.raises(ValueError, match="not the ones it was built for"):
        compiled(other, batch_fn(0))
    rebound = {"params": {k: v for k, v in state["params"].items()}, "opt": dict(state["opt"])}
    rebound["opt"]["step"] = state["opt"]["step"].clone()
    with pytest.raises(ValueError, match="not the ones it was built for"):
        compiled(rebound, batch_fn(0))
    assert compiled.counts()["calls"] == 0


def test_supervisor_matches_the_jax_supervisor(tmp_path):
    """The port's Supervisor and the JAX Supervisor from the same weights,
    on the same SyntheticLM batches with a failure at step 7 and a
    checkpoint every 5 steps: the same steps, restarts, metrics (replays
    included) and losses."""
    jcfg = jax_reduced(jax_get_config("smollm-360m"))
    jtcfg = jax_step.TrainConfig()
    jstate = jax_step.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                             reduced(get_config("smollm-360m")), device="cpu")
    cfg, tcfg, state, step, batch_fn = _mk(params=params)
    jdata = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(jcfg.vocab_size, 32, 4, seed=5))
    kw = dict(ckpt_every=5, max_steps=12)
    jsup = jax_sup.Supervisor(
        jax_sup.SupervisorConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
        jax.jit(jax_step.make_train_step(jcfg, jtcfg), donate_argnums=(0,)),
        # the write of step 5 joined before each step, so that the JAX
        # supervisor, which does not wait for it, restores from it too
        lambda i: (jsup.ckpt.wait(), {k: jnp.asarray(v) for k, v in jdata.batch(i).items()})[1],
        jstate, failures=jax_sup.FailureInjector((7,)),
    )
    jout = jsup.run()
    out = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "torch"), **kw), step, batch_fn,
                     state, failures=FailureInjector((7,))).run()
    assert out["steps"] == jout["steps"] == 12
    assert out["restarts"] == jout["restarts"] == 1
    assert len(out["metrics"]) == len(jout["metrics"]) == 14
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               [float(m["loss"]) for m in jout["metrics"]], rtol=LOSS_TOL)


def test_train_driver_with_a_failure(tmp_path, capsys):
    rec = train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "4",
                          "--batch", "2", "--seq", "16", "--fail-at", "2",
                          "--ckpt-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert line["steps"] == 4 and line["restarts"] == 1 and line["stragglers"] == 0
    # steps 0 and 1, the failure before step 2, then steps 0-3 from the
    # step-0 checkpoint: six calls, no graph on the CPU
    assert line["compiled"] == {"calls": 6, "captures": 0, "replays": 0}
    assert np.isfinite(line["first_loss"]) and np.isfinite(line["last_loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000000", "step_00000004"]


def test_train_driver_checkpoints_into_a_fresh_temporary_dir(tmp_path, monkeypatch, capsys):
    """Without ``--ckpt-dir`` the driver checkpoints into a new directory
    under the temporary directory (``$TMPDIR``), so no run restores
    another's checkpoints, and removes it when the run ends."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = {}
    run = Supervisor.run

    def spy(self):
        out = run(self)
        seen["dir"] = self.cfg.ckpt_dir
        seen["ckpts"] = sorted(os.listdir(self.cfg.ckpt_dir))
        return out

    monkeypatch.setattr(Supervisor, "run", spy)
    rec = train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "4",
                          "--batch", "2", "--seq", "16", "--fail-at", "2"])
    capsys.readouterr()
    assert rec["restarts"] == 1 and rec["compiled"]["calls"] == 6
    assert os.path.dirname(seen["dir"]) == str(tmp_path)
    assert os.path.basename(seen["dir"]).startswith("repro_torch_ckpt_")
    assert seen["ckpts"] == ["step_00000000", "step_00000004"]
    assert not os.path.exists(seen["dir"])
    assert [d for d in os.listdir(tmp_path) if d.startswith("repro_torch_ckpt_")] == []


def test_supervisor_without_checkpoints(tmp_path):
    """``ckpt_every`` 0 writes no checkpoint and trains as a run with
    checkpoints does; a failure in it cannot restart and is raised."""
    _, _, state_a, step, batch_fn = _mk()
    _, _, state_b, _, _ = _mk()
    out_a = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=3, max_steps=6),
                       step, batch_fn, state_a, log=EventLog()).run()
    log = EventLog()
    out_b = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=0, max_steps=6),
                       step, batch_fn, state_b, log=log).run()
    assert [m["loss"] for m in out_b["metrics"]] == [m["loss"] for m in out_a["metrics"]]
    assert not (tmp_path / "b").exists() or os.listdir(tmp_path / "b") == []
    assert log.events("spawn", "checkpoint") == [] and out_b["steps"] == 6
    _, _, state_c, _, _ = _mk()
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "c"), ckpt_every=0, max_steps=6),
                     step, batch_fn, state_c, failures=FailureInjector((2,)))
    with pytest.raises(NodeFailure):
        sup.run()
    assert sup.restarts == 1 and sup.step == 2


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b", "chameleon-34b", "musicgen-large"])
def test_train_driver_trains_the_dense_archs(arch, capsys):
    """The archs K1b's head dims 128 and 256 bring to the card train through
    the driver (reduced, on the CPU), without checkpoints (--ckpt-every 0)."""
    rec = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--ckpt-every", "0"])
    capsys.readouterr()
    assert rec["steps"] == 3 and rec["restarts"] == 0 and len(rec["losses"]) == 3
    assert rec["compiled"] == {"calls": 3, "captures": 0, "replays": 0}
    assert all(np.isfinite(rec["losses"]))


def test_train_driver_refuses_failures_without_checkpoints(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "4",
                        "--ckpt-every", "0", "--fail-at", "2"])
    assert "--fail-at needs checkpoints" in capsys.readouterr().err


def _local_mesh():
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh("cpu")


def test_elastic_reshard_across_meshes(tmp_path):
    """A checkpoint of whole tensors restores onto a mesh (``shardings``),
    and a sharded state is saved whole (the JAX test at 1-device scale:
    1 x 1)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import destroy_mesh

    state = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(8.0)}
    axes = {"w": "embed,mlp", "b": "mlp"}
    save(str(tmp_path), 1, state)
    mesh = _local_mesh()
    try:
        shardings = shd.tree_shardings(axes, state, shd.PARAM_RULES, mesh)
        got = restore(str(tmp_path), 1, state, shardings=shardings)
        assert isinstance(got["w"], DTensor) and got["w"].device_mesh is mesh
        assert tuple(got["w"].placements) == shardings["w"].placements
        assert torch.equal(got["w"].full_tensor(), state["w"])
        save(str(tmp_path), 2, got)  # a DTensor leaf is written whole
        back = restore(str(tmp_path), 2, state)
        assert not isinstance(back["w"], DTensor) and torch.equal(back["w"], state["w"])
        live = shd.distribute({k: torch.zeros_like(v) for k, v in state.items()}, axes,
                              shd.PARAM_RULES, mesh)
        ptr = live["w"].to_local().data_ptr()
        restore_into(str(tmp_path), 1, live)  # each rank's shard, in place
        assert live["w"].to_local().data_ptr() == ptr
        assert torch.equal(live["w"].full_tensor(), state["w"])
    finally:
        destroy_mesh()


def test_supervisor_resize_mid_run_equals_the_run_that_never_moved(tmp_path):
    """Two steps on a 1 x 1 mesh, off it for two, back on it for two, with a
    restart (a restore into the sharded state) after the move back: the
    losses equal the plain run's bit for bit, and each move is an
    ``elastic_resize`` span."""
    import functools

    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import destroy_mesh
    from repro_torch.training.step import on_mesh, train_state_axes

    cfg, tcfg, plain_state, step, batch_fn = _mk()
    plain = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "plain"), ckpt_every=0,
                                        max_steps=6), step, batch_fn, plain_state)
    want = [m["loss"] for m in plain.run()["metrics"]]
    _, _, state, _, _ = _mk()
    mesh = _local_mesh()
    try:
        reshard = functools.partial(shd.reshard, tree_axes=train_state_axes(cfg),
                                    rules=shd.PARAM_RULES)

        def move(tree, new_mesh):
            return reshard(tree, mesh=new_mesh)

        state, shardings = move(state, mesh)
        log = EventLog()
        sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "moved"), ckpt_every=2,
                                          max_steps=2),
                         on_mesh(step, mesh), batch_fn, state, state_shardings=shardings,
                         log=log, failures=FailureInjector((5,)))
        got = [m["loss"] for m in sup.run()["metrics"]]
        sup.resize(None, move)
        assert sup.state_shardings is None
        assert not isinstance(sup.state["params"]["embed"]["table"], DTensor)
        sup.cfg.max_steps = 4
        got += [m["loss"] for m in sup.run()["metrics"]]
        sup.resize(mesh, move)
        assert isinstance(sup.state["params"]["embed"]["table"], DTensor)
        assert sup.state["params"]["embed"]["table"].is_leaf
        sup.cfg.max_steps = 6
        out = sup.run()
        assert out["restarts"] == 1  # step 5 failed: restored from step 4's checkpoint
        got += [m["loss"] for m in out["metrics"]][-2:]
        assert got == want
        assert len(log.events("spawn", "elastic_resize")) == 2
    finally:
        destroy_mesh()
