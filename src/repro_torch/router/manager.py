"""ReplicaManager: spawn, watch and resurrect the replica fleet
(counterpart of ``repro/router/manager.py``).

Each replica is a ``python -m repro_torch.router.replica`` subprocess (with
this checkout's ``src`` on its ``PYTHONPATH``) launched with
``--port 0`` and a per-replica ready file (the shared handshake from
:mod:`repro_torch.utils.ready`), its stdout/stderr captured to per-replica log
files under the workdir.  A supervisor thread then runs a small state
machine per replica:

``up`` → (process exit or repeated ``/healthz`` failures) → ``backoff`` →
(exponential delay, capped) → ``starting`` → (ready file reappears, on a
**new** port) → ``up``.

Every transition is recorded as a ``mark``/``replica`` trace event on the
router track and mirrored into ``repro_router_replica_up`` /
``repro_router_replica_restarts_total``; the ``on_up``/``on_down`` callbacks
are how the :class:`~repro_torch.router.cost.CostRouter` learns a replica's
current URL and routability.  Liveness needs both probes: ``proc.poll()``
catches a SIGKILLed child instantly, the ``/healthz`` GET catches a process
that is alive but wedged (the supervisor kills it and restarts).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Optional

from repro_torch.core.events import EventLog
from repro_torch.utils.ready import read_ready_info, wait_for_ready_file

HEALTH_FAILS_TO_RESTART = 3  # consecutive /healthz failures ⇒ wedged
# the directory that holds repro_torch: the replicas import it from there
SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass
class ReplicaHandle:
    name: str
    ready_file: str
    log_path: str
    proc: Optional[subprocess.Popen] = None
    url: str = ""
    info: dict[str, Any] = dataclasses.field(default_factory=dict)
    state: str = "starting"  # starting | up | backoff
    restarts: int = 0
    backoff_s: float = 0.0
    resume_at: float = 0.0
    start_deadline: float = 0.0
    health_fails: int = 0

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class ReplicaManager:
    """Spawn N replicas, keep them alive, tell the router who is routable."""

    def __init__(
        self,
        count: int,
        replica_argv: list[str],
        workdir: str,
        *,
        log: Optional[EventLog] = None,
        registry: Optional[Any] = None,
        on_up: Optional[Callable[[str, str, dict[str, Any]], None]] = None,
        on_down: Optional[Callable[[str, str], None]] = None,
        poll_s: float = 0.5,
        backoff_s: float = 0.5,
        max_backoff_s: float = 8.0,
        startup_timeout_s: float = 120.0,
        python: str = sys.executable,
    ) -> None:
        if count < 1:
            raise ValueError(f"count must be >= 1 (got {count})")
        self.count = count
        self.replica_argv = list(replica_argv)
        self.workdir = workdir
        self.log = log
        self.registry = registry
        self.on_up = on_up
        self.on_down = on_down
        self.poll_s = poll_s
        self.backoff0_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.startup_timeout_s = startup_timeout_s
        self.python = python
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.replicas: dict[str, ReplicaHandle] = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ReplicaManager":
        """Spawn all replicas, block until every one is ready, then supervise."""
        os.makedirs(self.workdir, exist_ok=True)
        for i in range(self.count):
            name = f"r{i}"
            h = ReplicaHandle(
                name=name,
                ready_file=os.path.join(self.workdir, f"{name}.ready"),
                log_path=os.path.join(self.workdir, f"{name}.log"),
            )
            self.replicas[name] = h
            self._spawn(h)
        for h in self.replicas.values():
            wait_for_ready_file(h.ready_file, self.startup_timeout_s,
                                proc=h.proc)
            self._became_ready(h)
        self._thread = threading.Thread(target=self._supervise,
                                        name="replica-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for h in self.replicas.values():
            if h.proc is not None and h.proc.poll() is None:
                h.proc.terminate()
        deadline = time.monotonic() + 5.0
        for h in self.replicas.values():
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=5.0)

    # -- internals ------------------------------------------------------------

    def _spawn(self, h: ReplicaHandle) -> None:
        if os.path.exists(h.ready_file):
            os.unlink(h.ready_file)  # stale URL must not look like readiness
        cmd = [self.python, "-m", "repro_torch.router.replica",
               "--name", h.name, "--port", "0",
               "--ready-file", h.ready_file] + self.replica_argv
        logf = open(h.log_path, "ab")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (SRC, env.get("PYTHONPATH", "")) if p)
        try:
            # cwd is inherited too: a relative PYTHONPATH=src (the repo's own
            # convention) keeps resolving inside the child
            h.proc = subprocess.Popen(cmd, stdout=logf, stderr=logf, env=env)
        finally:
            logf.close()  # the child holds its own fd
        h.state = "starting"
        h.start_deadline = time.monotonic() + self.startup_timeout_s
        h.health_fails = 0
        self._event(h, "starting", pid=h.pid)

    def _became_ready(self, h: ReplicaHandle) -> None:
        h.info = read_ready_info(h.ready_file)
        h.url = h.info["url"]
        h.state = "up"
        h.backoff_s = 0.0
        h.health_fails = 0
        self._event(h, "up", pid=h.pid, url=h.url)
        self._gauge(h, 1.0)
        if self.on_up is not None:
            self.on_up(h.name, h.url, h.info)

    def _went_down(self, h: ReplicaHandle, reason: str) -> None:
        h.restarts += 1
        h.backoff_s = (self.backoff0_s if h.backoff_s == 0.0
                       else min(h.backoff_s * 2, self.max_backoff_s))
        h.state = "backoff"
        h.resume_at = time.monotonic() + h.backoff_s
        self._event(h, "down", reason=reason, restarts=h.restarts,
                    backoff_s=h.backoff_s)
        self._gauge(h, 0.0)
        if self.registry is not None:
            self.registry.counter(
                "repro_router_replica_restarts_total",
                "replica restarts by the supervisor",
                replica=h.name).inc()
        if self.on_down is not None:
            self.on_down(h.name, reason)

    def _healthz_ok(self, h: ReplicaHandle) -> bool:
        try:
            with urllib.request.urlopen(f"{h.url}/healthz", timeout=2.0) as r:
                return bool(json.loads(r.read()).get("ok"))
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                OSError, ValueError):
            return False

    def _supervise(self) -> None:
        while not self._stop.wait(self.poll_s):
            for h in self.replicas.values():
                try:
                    self._tick(h)
                except Exception as exc:  # supervisor must never die
                    self._event(h, "supervisor-error", error=repr(exc))

    def _tick(self, h: ReplicaHandle) -> None:
        now = time.monotonic()
        if h.state == "up":
            rc = h.proc.poll() if h.proc is not None else -1
            if rc is not None:
                self._went_down(h, f"exited rc={rc}")
                return
            if self._healthz_ok(h):
                h.health_fails = 0
            else:
                h.health_fails += 1
                if h.health_fails >= HEALTH_FAILS_TO_RESTART:
                    # alive but unresponsive: put it out of its misery
                    h.proc.kill()
                    h.proc.wait(timeout=10.0)
                    self._went_down(
                        h, f"unresponsive ({h.health_fails} healthz failures)")
        elif h.state == "backoff":
            if now >= h.resume_at:
                self._spawn(h)
        elif h.state == "starting":
            if h.proc is not None and h.proc.poll() is not None:
                self._went_down(h, f"died during startup rc={h.proc.returncode}")
                return
            if os.path.exists(h.ready_file):
                try:
                    self._became_ready(h)
                except (ValueError, OSError):
                    pass  # torn/half-written: next tick re-reads
            elif now >= h.start_deadline:
                if h.proc is not None:
                    h.proc.kill()
                    h.proc.wait(timeout=10.0)
                self._went_down(h, "startup timeout")

    # -- observability --------------------------------------------------------

    def _event(self, h: ReplicaHandle, state: str, **extra: Any) -> None:
        if self.log is not None:
            self.log.record("mark", "replica",
                            {"replica": h.name, "state": state, **extra})

    def _gauge(self, h: ReplicaHandle, v: float) -> None:
        if self.registry is not None:
            self.registry.gauge("repro_router_replica_up",
                                "replica routable (1) or down (0)",
                                replica=h.name).set(v)

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                h.name: {
                    "state": h.state,
                    "pid": h.pid,
                    "url": h.url,
                    "restarts": h.restarts,
                    "chip": h.info.get("chip"),
                    "git_sha": h.info.get("git_sha"),
                }
                for h in self.replicas.values()
            }
