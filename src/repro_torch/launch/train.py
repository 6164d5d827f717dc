"""Training driver: the train step under the supervisor, over synthetic data.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced --device cpu \
      --fail-at 2 --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --steps 6 --batch 4 \
      --seq 2048 --ckpt-every 0

Counterpart of ``repro/launch/train.py``.  Weights are random, drawn from
``--seed`` on the device; batch ``i`` is ``SyntheticLM`` batch ``i`` (the
same arrays as the JAX driver's for the same seed).  The schedule is the
JAX driver's: warmup over max(10, steps // 10) steps, cosine decay over
``--steps``.  Every step runs under ``runtime/supervisor.py``'s
``Supervisor``: a checkpoint of step 0 and every ``--ckpt-every`` steps in
``--ckpt-dir``, and ``--fail-at`` injects node failures before the listed
steps, after which it restarts from the newest checkpoint and replays.
Without ``--ckpt-dir`` the checkpoints go to a fresh directory under the
temporary directory (``$TMPDIR``), removed when the run ends.  A given
directory is kept; if it already holds checkpoints, no step-0 checkpoint
is written and a failure restores the newest one there, which may be an
earlier run's: give a fresh one.  ``--ckpt-every 0`` writes no checkpoint
(a full-width gemma3-4b's state, bf16 params and f32 moments, is 39 GB a
copy); such a run cannot restart, so ``--fail-at`` needs checkpoints.  On
the card the step is captured as a CUDA graph (``training/compiled.py``):
the first step runs eagerly, the second is captured, every later one
(replays after a restart too) is a replay.  On the CPU it runs eagerly.

Prints one JSON line with ``arch``, ``steps``, ``restarts``,
``stragglers``, ``first_loss``, ``last_loss``, ``tokens_per_s`` and
``wall_s`` (the JAX driver's fields), plus ``device``, ``step_ms`` (the
median step), ``kernels``, the launch count of each Hopper kernel in the
run (all 0 on the CPU, where the plain versions run), and ``compiled``, the
compiled step's ``calls`` / ``captures`` / ``replays``.

On the card attention and RMSNorm differentiate through their kernels
(K1 + K1b, K3 + K3b), which cover every dense arch: K1b has instances at
head dims 64 (smollm-360m, qwen2-0.5b, musicgen-large), 128 (gemma2-27b,
chameleon-34b) and 256 (gemma3-4b).  The frontend archs train on tokens
alone here: this driver passes no frontend embeddings, as the JAX driver
passes none.  One card holds gemma3-4b and musicgen-large whole, with
bf16 params and grads and f32 moments (12 bytes a parameter); gemma2-27b
and chameleon-34b need more (326 and 412 GB).
An arch whose path reaches the grouped matmul, the Mamba scan or the RWKV6
scan (K4, K5, K6: deepseek-moe-16b, dbrx-132b, jamba-1.5-large, rwkv6-7b)
has no backward kernel there yet: the driver stops with the ROADMAP Queue 2
item that brings it (K4b, K5b, K6b).

``--dispatch {static,roofline,profiled}`` routes every step through
``dispatch/`` between the tiers that run on ``--device`` (``kernel`` and
``plain`` on the card, ``plain`` on the CPU), each its own compiled step
over the same state tensors; ``--dispatch-backend``, ``--profile-in`` and
``--profile-out`` and the JSON line's dispatch fields are the serve
driver's (``launch/serve.py``).  On the card a compiled step's first call
runs eagerly and its second captures, so a tier warms after 3 steps there
(``min_samples=3``: every warm set holds a replay), after 2 on the CPU.
``compiled`` then holds each tier's counts, and the line gains
``step_backends``, the tier of each step's last run.  ``losses`` is the
loss of each step's last run, in step order.

The trace and metrics flags (``--trace-out``, ``--trace-dir``,
``--trace-rotate``, ``--trace-rotate-keep``, ``--trace-capacity``,
``--metrics-port``, ``--trace-overhead-budget-pct``, ``--ready-file``,
``--metrics-linger-s`` and ``--torch-profile*``) and the JSON line's trace
fields are the serve driver's; the run is a ``train_run`` span, and a
``--trace-dir`` stream rotates at every checkpoint and at the end.

Fleet mode and kernel autotuning, the serve driver's flags: ``--fleet``
(with ``--dispatch``) pulls the best matching profile snapshot before the
step variants are built and pushes the measured delta at the end and at
each streaming rotation (``--fleet-token`` authenticates); ``--tune
{cached,sweep}`` (with ``--tune-ops``, ``--tune-mode``, ``--tune-workers``)
installs the design-space winners after the pull and before the steps are
built, so every captured step runs under them.  The JSON line gains
``fleet`` and ``tune`` as the serve driver's.

``--mesh DxM`` trains on a ``(data, model)`` mesh: the train state is
distributed by ``distributed.sharding.rules_for_shape("train", ...)`` (the
JAX package's rules), the step runs on DTensors under ``mesh_scope`` (eager
and as ``CompiledTrainStep``), and the JSON line gains ``mesh``, as the JAX
driver's.  On the card the mesh is one of the machine's cards per rank,
and the driver refuses a mesh larger than the machine (one H100: ``1x1``,
an ``nccl`` group of one rank, whose losses equal the run without a mesh
bit for bit).  With ``--device cpu`` a mesh of N devices is real sharded
execution over N ``gloo`` ranks that the driver spawns itself, the
counterpart of the JAX driver's host devices; rank 0 prints the JSON line,
and each rank checkpoints into its own ``rank<r>`` subdirectory.  Without
``--mesh`` there is no mesh and no process group (the line's ``mesh`` is
null).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dispatch import with_impl
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.launch.serve import (TracePlane, add_dispatch_args, add_fleet_args,
                                     add_trace_args, add_tune_args, check_tune_args,
                                     dispatch_record, make_dispatcher, tune, warm_start)
from repro_torch.runtime.supervisor import FailureInjector, Supervisor, SupervisorConfig
from repro_torch.training import optim
from repro_torch.training.compiled import CompiledTrainStep
from repro_torch.training.step import TrainConfig, init_train_state, train_state_axes


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints; 0 writes none (and cannot restart)")
    ap.add_argument("--fail-at", default="", help="comma list of steps to inject failures")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    add_dispatch_args(ap, "each train step")
    add_fleet_args(ap)
    add_tune_args(ap)
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) mesh to train on, e.g. 1x1 or 1x2; default: none")
    add_trace_args(ap)
    args = ap.parse_args(argv)
    if args.ckpt_every < 0 or (args.ckpt_every == 0 and args.fail_at):
        ap.error("--ckpt-every must be >= 0, and --fail-at needs checkpoints (--ckpt-every > 0)")
    if args.fleet and args.dispatch == "off":
        # a fleet-less run would silently neither warm-start nor push
        ap.error("--fleet requires --dispatch (static|roofline|profiled)")
    check_tune_args(args, ap)

    if args.mesh is not None:
        try:
            mesh_mod.parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        if args.dispatch != "off":
            ap.error("--mesh trains one step on its mesh; --dispatch routes between steps: "
                     "use one of them")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(
        opt=optim.AdamWConfig(peak_lr=args.lr, warmup_steps=max(10, args.steps // 10),
                              total_steps=args.steps),
        microbatches=args.microbatches,
    )
    mesh, rank, children = _mesh(args, device, argv)
    state = init_train_state(cfg, tcfg, args.seed, device)
    if mesh is not None:
        rules = shd.rules_for_shape("train", global_batch=args.batch, seq_len=args.seq,
                                    mesh=mesh, n_kv_heads=cfg.n_kv_heads)
        state = shd.distribute(state, train_state_axes(cfg), rules.param, mesh)
    trace = TracePlane(args, ap, device)
    log = trace.log
    dispatcher, aged = make_dispatcher(args, device, log)
    run_meta = {"driver": "train", "arch": cfg.name, "steps": args.steps}
    fleet_rec, pusher = warm_start(args, dispatcher, run_meta)
    # after the fleet pull and before the step variants are built: every
    # captured step runs under the installed winners
    tune_rec = tune(args, dispatcher, log)
    trace.open_stream(run_meta, dispatcher, pusher)
    if dispatcher is None:
        steps = {None: CompiledTrainStep(cfg, tcfg, state, mesh=mesh)}
        step_variants = None
    else:  # one compiled step per tier, all over the same state tensors
        steps = {t.name: CompiledTrainStep(cfg, tcfg, state)
                 for t in dispatcher.registry.targets()}
        step_variants = {t.name: with_impl(t.impl, steps[t.name])
                         for t in dispatcher.registry.targets()}
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    order: list[int] = []  # the step of each call, replays after a restart too

    def batch_fn(i: int) -> dict:
        order.append(i)
        return {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}

    ckpt_ctx = contextlib.nullcontext(args.ckpt_dir) if args.ckpt_dir else \
        tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_")
    with ckpt_ctx as ckpt_dir:
        if mesh is not None and mesh.size() > 1:
            # every rank its own checkpoints: a restore never reads another's write
            ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
        sup = Supervisor(
            SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                             max_steps=args.steps),
            steps.get(None), batch_fn, state, log=log,
            failures=FailureInjector(tuple(int(s) for s in args.fail_at.split(",") if s)),
            dispatcher=dispatcher, step_variants=step_variants, stream=trace.stream,
        )
        reset_launches()
        trace.start()
        t0 = time.time()
        try:
            with log.lifecycle("train_run", {"arch": cfg.name, "steps": args.steps}):
                out = sup.run()
        except RuntimeError as e:
            if "ROADMAP" not in str(e):
                raise
            raise SystemExit(f"{cfg.name} cannot train on {device} yet: {e}") from e
        wall = time.time() - t0
        trace.stop_capture()
    # a failure is raised before its step's batch is drawn: calls and
    # metrics pair one to one, and a replayed step's later run wins
    last = dict(zip(order, (m["loss"] for m in out["metrics"])))
    losses = [last[i] for i in range(out["steps"])]
    rec = {
        "arch": cfg.name,
        "steps": out["steps"],
        "restarts": out["restarts"],
        "stragglers": out["stragglers"],
        "first_loss": out["metrics"][0]["loss"],
        "last_loss": out["metrics"][-1]["loss"],
        "tokens_per_s": round(out["steps"] * args.batch * args.seq / wall, 1),
        "wall_s": round(wall, 2),
        "step_ms": round(1e3 * statistics.median(sup.durations), 2),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "kernels": launch_counts(),
        "compiled": (steps[None].counts() if dispatcher is None
                     else {name: s.counts() for name, s in steps.items()}),
        "losses": losses,
        "mesh": args.mesh,
        **dispatch_record(args, dispatcher, aged, log),
    }
    if dispatcher is not None:
        backend = dict(zip(order, (d.backend for d in dispatcher.decisions)))
        rec["step_backends"] = [backend[i] for i in range(out["steps"])]
    if tune_rec is not None:
        rec["tune"] = tune_rec
    rec.update(trace.record(dispatcher, run_meta))
    if pusher is not None:
        final = pusher.push()  # the rest of the delta (none if a rotation sent it)
        fleet_rec["push"] = {"pushed_samples": pusher.pushed_samples}
        if "error" in final:
            fleet_rec["push"]["error"] = final["error"]
        rec["fleet"] = fleet_rec
    if rank == 0:
        print(json.dumps(rec), flush=True)
    trace.close()
    if mesh is not None:
        mesh_mod.destroy_mesh()
    _join(children)
    return rec


def _mesh(args: argparse.Namespace, device: torch.device, argv: list[str] | None):
    """(mesh or None, this process's rank, the rank processes it spawned).

    On the CPU a mesh of N > 1 devices is N gloo ranks: the first process
    (no ``RANK`` in its environment) is rank 0 and starts ranks 1..N-1 as
    copies of itself; on the card every rank needs its own card."""
    if args.mesh is None:
        return None, 0, []
    data, model = mesh_mod.parse_mesh(args.mesh)
    n = data * model
    rank, world = mesh_mod.rank_env()
    children: list = []
    init = os.environ.get("REPRO_TORCH_INIT")
    if "RANK" not in os.environ and n > 1:
        if device.type != "cpu":
            # one card a rank, all on this machine: build_mesh refuses a mesh
            # larger than it, as the JAX driver refuses one larger than its devices
            mesh_mod.build_mesh(args.mesh, device.type)
        init = f"tcp://localhost:{mesh_mod.free_port()}"
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               *(sys.argv[1:] if argv is None else argv)]
        for r in range(1, n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), REPRO_TORCH_INIT=init)
            children.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL))
        rank, world = 0, n
    mesh_mod.init_world(device.type, rank=rank, world_size=world, init_method=init)
    try:
        return mesh_mod.build_mesh(args.mesh, device.type), rank, children
    except Exception:
        _join(children, kill=True)
        raise


def _join(children: list, kill: bool = False) -> None:
    for c in children:
        if kill:
            c.kill()
        if c.wait() != 0 and not kill:
            raise SystemExit(f"a rank process exited {c.returncode}")


if __name__ == "__main__":
    main()
