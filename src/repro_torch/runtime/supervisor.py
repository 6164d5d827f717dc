"""Training supervisor: checkpoint / restart, failure injection, stragglers
(counterpart of ``repro/runtime/supervisor.py``).

* **Failure detection + restart.**  A step that raises :class:`NodeFailure`
  (injected by :class:`FailureInjector`) rolls back to the last checkpoint
  and replays.  The data is indexed by the step (``batch_fn(step)``), so
  the replay is bit for bit the run without the failure.
* **Restore in place.**  The port's steps write params, moments and the step
  counter in place, and a compiled step (``training/compiled.py``) reads and
  writes them at the addresses its CUDA graph captured.  So a restore copies
  the checkpoint into the live tensors of the state; a state rebound to new
  tensors would leave the graph training the old ones.  For the same reason
  step 0 is checkpointed before the first step, as the reference does
  before its first donating step.  ``ckpt_every`` 0 writes no checkpoint at
  all (a copy of a full-width gemma3-4b's state, bf16 params and f32
  moments, is 39 GB); such a run cannot restart, so a failure in it is
  raised.
* **Straggler detection.**  A step slower than ``straggler_factor`` x the
  median of the last ``straggler_window`` steps (after 5) is recorded as a
  ``straggler`` event under its step's span and counted.
* **Lifecycle tracing.**  step / checkpoint / restart spawn-exit brackets
  go into the :class:`~repro_torch.core.events.EventLog`; while a live
  device profiler is active, each step's work runs under its ``span=<id>``
  annotation (``trace/liveprof.py``), so its kernels (or the graph it
  replays) bind to the step.  ``stream`` (a
  :class:`~repro_torch.trace.stream.StreamingSession`) is rotated at every
  checkpoint and at the end, so the trace on disk is never staler than the
  model state on disk: a crash recovers both to the same point.
* **Profile-guided placement.**  Given a ``dispatcher`` and
  ``step_variants`` (target name -> step, each its own compiled step over
  the same state tensors, run under its target's impl: ``with_impl``),
  every step goes through ``dispatcher.dispatch("train_step", ...)``
  inside the step's span, so the decision is the step's child.  A restore
  copies into the tensors every variant's graph reads, so each still
  serves after a restart.

* **Elastic re-mesh.**  :meth:`Supervisor.resize` moves the live state
  onto a new mesh (or off every mesh) with a ``reshard_fn(state, mesh) ->
  (state, shardings)`` (``distributed.sharding.reshard`` with the axes and
  rules bound), under an ``elastic_resize`` lifecycle span.  The resized
  state is new tensors, so a step bound to the old ones (a compiled step)
  must be rebuilt; the eager step takes either.  ``state_shardings``
  records the state's shardings (None: whole tensors), and a restore
  copies each rank's shard into the live DTensors.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Mapping, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_into
from repro_torch.core.events import GLOBAL_LOG, EventLog
from repro_torch.dispatch.dispatcher import Dispatcher
from repro_torch.dispatch.profiles import signature
from repro_torch.trace.liveprof import device_annotation

Tree = Any


class NodeFailure(RuntimeError):
    """Simulated (or surfaced) loss of a worker during a step."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: fail just before the listed steps,
    once each."""

    fail_at_steps: tuple[int, ...] = ()
    _already: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._already:
            self._already.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50  # 0: no checkpoints, and no restarts
    max_steps: int = 200
    straggler_factor: float = 3.0  # deadline = factor x rolling median
    straggler_window: int = 20
    max_restarts: int = 10


class Supervisor:
    """Runs ``train_step`` under fault tolerance.

    ``train_step(state, batch) -> (state, metrics)`` updates ``state`` in
    place (the eager step of ``training/step.py`` or the compiled one of
    ``training/compiled.py``), with metrics 0-dim tensors; ``batch_fn(step)
    -> batch`` must be indexed by the step alone (resumable).
    """

    def __init__(
        self,
        cfg: SupervisorConfig,
        train_step: Callable,
        batch_fn: Callable[[int], Any],
        init_state: Tree,
        *,
        state_shardings: Optional[Tree] = None,
        log: Optional[EventLog] = None,
        failures: Optional[FailureInjector] = None,
        dispatcher: Optional[Dispatcher] = None,
        step_variants: Optional[Mapping[str, Callable]] = None,
        stream: Optional[Any] = None,
    ) -> None:
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        # profile-guided placement: when both are given, each step routes to
        # the argmin-cost variant (see repro_torch.dispatch)
        self.dispatcher = dispatcher
        self.step_variants = dict(step_variants) if step_variants else None
        # per-backend tuned-config tags, resolved at the first dispatched step
        self._configs: Optional[dict] = None
        self.stream = stream
        self.state = init_state
        self.state_shardings = state_shardings
        self.log = GLOBAL_LOG if log is None else log
        self.failures = failures or FailureInjector()
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.step = 0
        self.restarts = 0
        self.stragglers = 0
        self.durations: list[float] = []  # seconds of each step run, replays too

    # -- fault handling ------------------------------------------------------

    def _restore_latest(self) -> None:
        self.ckpt.wait()  # a write in flight lands first: the newest one saved is restored
        last = latest_step(self.cfg.ckpt_dir)
        with self.log.lifecycle("restart", {"from_step": last}):
            if last is None:
                self.step = 0  # restart from scratch
                return
            restore_into(self.cfg.ckpt_dir, last, self.state)
            self.step = last

    def resize(self, new_mesh: Optional[Any],
               reshard_fn: Callable[[Tree, Optional[Any]], tuple[Tree, Optional[Tree]]]
               ) -> None:
        """Elastic re-mesh: move the live state onto ``new_mesh`` (None: off
        every mesh)."""
        shape = None if new_mesh is None else tuple(new_mesh.shape)
        with self.log.lifecycle("elastic_resize", {"mesh": str(shape)}):
            self.state, self.state_shardings = reshard_fn(self.state, new_mesh)

    # -- main loop -----------------------------------------------------------

    def _deadline(self) -> Optional[float]:
        if len(self.durations) < 5:
            return None
        window = self.durations[-self.cfg.straggler_window:]
        return self.cfg.straggler_factor * statistics.median(window)

    def run(self) -> dict[str, Any]:
        metrics_hist = []
        every = self.cfg.ckpt_every
        if every > 0 and latest_step(self.cfg.ckpt_dir) is None:
            # step 0 before the first (in-place) step: a restart from scratch
            # needs the state as it was
            with self.log.lifecycle("checkpoint", 0):
                self.ckpt.save(0, self.state)
        while self.step < self.cfg.max_steps:
            try:
                with self.log.lifecycle("step", self.step) as step_span, \
                        device_annotation(step_span):
                    self.failures.maybe_fail(self.step)
                    t0 = time.monotonic()
                    batch = self.batch_fn(self.step)
                    if self.dispatcher is not None and self.step_variants:
                        # inside the step's span: the dispatch event lands
                        # in the span tree as the step's child
                        if self._configs is None:
                            self._configs = self.dispatcher.active_configs()
                        self.state, metrics = self.dispatcher.dispatch(
                            "train_step", self.step_variants, self.state, batch,
                            sig=signature(batch),  # the state's shapes are fixed
                            configs=self._configs,
                        )
                    else:
                        self.state, metrics = self.train_step(self.state, batch)
                    # the host copy waits for the step (block_until_ready +
                    # device_get); a compiled step's metrics live in its
                    # graph's pool only until the next replay
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.monotonic() - t0
                deadline = self._deadline()
                if deadline is not None and dt > deadline:
                    self.stragglers += 1
                    # recorded after the step closed, but caused by it
                    self.log.record("straggler", "step", {"step": self.step, "s": dt},
                                    parent=step_span)
                self.durations.append(dt)
                metrics_hist.append(metrics)
                self.step += 1
                if every > 0 and self.step % every == 0:
                    with self.log.lifecycle("checkpoint", self.step, parent=step_span):
                        self.ckpt.save(self.step, self.state)
                    if self.stream is not None:
                        self.stream.rotate()
            except NodeFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts or every <= 0:
                    raise
                self._restore_latest()
        self.ckpt.wait()
        if every > 0:
            with self.log.lifecycle("checkpoint", self.step):
                self.ckpt.save(self.step, self.state)
                self.ckpt.wait()
        if self.stream is not None:
            self.stream.rotate()
        return {
            "steps": self.step,
            "restarts": self.restarts,
            "stragglers": self.stragglers,
            "metrics": metrics_hist,
            # a bounded log on a long run drops its oldest events: the count
            # keeps the loss visible in the driver's JSON
            "trace": {
                "events": len(self.log),
                "dropped": self.log.dropped,
                "capacity": self.log.maxlen,
                **(self.log.drop_counters() if hasattr(self.log, "drop_counters") else {}),
            },
        }
