"""One serve replica: an HTTP front over a continuous-batching engine
(counterpart of ``repro/router/replica.py``: the same wire format, span
tree and ready file).

``python -m repro_torch.router.replica`` turns the batch-driven
:class:`repro_torch.serving.engine.Engine` into a long-lived process the router can
spawn, poll and route to:

* ``POST /v1/generate`` ``{"prompt": [...], "max_new": N}`` — submit one
  request and block until its tokens are ready (the engine keeps batching
  underneath: concurrent requests share decode ticks);
* ``GET /healthz`` — liveness + identity (pid, chip, git SHA) + occupancy,
  and for a real engine its ``kernels`` launch counts (the dict
  ``launch.serve`` prints) and its dispatcher's summary;
* ``GET /metrics`` / ``/metrics.json`` — the replica's own metrics plane.

Startup follows the shared ready-file handshake (:mod:`repro_torch.utils.ready`):
bind ``--port 0``, then atomically write a JSON ready file carrying the URL
plus the identity the router needs for fleet profile seeding.

``--synthetic`` swaps in :class:`SyntheticEngine` — same scheduling shape
(bounded slots, per-tick token production) with **deterministic** outputs
(:func:`expected_synthetic_tokens`) and a configurable per-tick sleep, and no
``torch`` import anywhere.  That is what the router tests run: a client can
recompute every expected token, so a request re-executed after a replica
SIGKILL is provably identical — exactly-once is verifiable, not assumed.

A real replica serves the port's compiled :class:`Engine` on ``--device``
(default ``cuda``; a replica that finds no card fails unless ``--device cpu``
was asked for), built as ``launch.serve`` builds it.  On the card the
compiled engine captures a CUDA graph at the second call of each step, and
a capture fails if another thread launches CUDA work meanwhile.  So every
CUDA call of a replica runs on its engine thread, which sets its own current
device: the engine is built before any other thread starts, HTTP handlers
only queue Python lists, and ``/healthz`` reads Python counters.
The kernels are built and loaded before the first request; a build or a
launch that fails ends the process with a non-zero exit.  The replica
stamps ``hw.specs.default_chip()`` (``h100_sxm``) and the checkout's SHA in
its ready file, its ``/healthz`` and, through its dispatcher, every profile
it pushes to ``--fleet`` (when its engine goes idle, at most every
``FLEET_PUSH_S`` seconds, and at exit).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import urlparse

from repro_torch.core.events import (EventLog, SpanContext, TRACEPARENT_HEADER,
                               current_span, next_span_id, span_scope)
from repro_torch.metrics import MetricsPlane
from repro_torch.trace.collector import TraceCollector
from repro_torch.utils.ready import write_ready_file

SYNTHETIC_VOCAB = 50257
FLEET_PUSH_S = 2.0  # a real replica pushes new profile samples at most this often
PREFILL_GRAPHS_PER_TIER = 4  # the Engine's default bound, for each dispatch tier


def expected_synthetic_tokens(prompt: list[int], max_new: int) -> list[int]:
    """The tokens a synthetic replica will emit for ``prompt`` — any replica,
    any restart.  Clients recompute this to verify exactly-once retries."""
    seed = sum(prompt) % 65521
    return [(seed * 31 + i * 7 + 11) % SYNTHETIC_VOCAB for i in range(max_new)]


@dataclasses.dataclass
class _SynRequest:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    span: int = 0
    parent: int = 0
    t_active: float = 0.0  # monotonic instant the request won a decode slot


class SyntheticEngine:
    """Engine-shaped synthetic server core: slots, ticks, deterministic tokens.

    Mirrors the real engine's client surface (``submit`` / ``step`` /
    ``pending``) and its request lifecycle events, but each decode tick
    sleeps ``ms_per_token`` instead of running a model — so scheduling,
    batching pressure and tail behaviour are exercised with zero accelerator
    (and zero ``torch`` import).
    """

    def __init__(self, *, max_batch: int = 4, ms_per_token: float = 2.0,
                 log: Optional[EventLog] = None,
                 metrics: Optional[Any] = None) -> None:
        self.max_batch = max_batch
        self.ms_per_token = ms_per_token
        self.log = log if log is not None else EventLog()
        self._lock = threading.Lock()
        self.queue: list[_SynRequest] = []
        self.active: list[Optional[_SynRequest]] = [None] * max_batch
        self._rid = 0
        self._g_queue = self._g_slots = None
        if metrics is not None:
            self._g_queue = metrics.gauge(
                "repro_serve_queue_depth", "requests waiting for a decode slot")
            self._g_slots = metrics.gauge(
                "repro_serve_active_slots", "occupied decode slots")

    def submit(self, prompt: list[int], max_new: int = 32) -> int:
        with self._lock:
            rid = self._rid
            self._rid += 1
            req = _SynRequest(rid, list(prompt), max_new,
                              span=next_span_id(), parent=current_span())
            self.queue.append(req)
            depth = len(self.queue)
        self.log.record("spawn", "request", req.rid, span=req.span,
                        parent=req.parent)
        if self._g_queue is not None:
            self._g_queue.set(depth)
        return rid

    def pending(self) -> int:
        with self._lock:
            return len(self.queue) + sum(r is not None for r in self.active)

    def step(self) -> list[_SynRequest]:
        with self._lock:
            for slot in range(self.max_batch):
                if self.active[slot] is None and self.queue:
                    req = self.queue.pop(0)
                    req.t_active = time.monotonic()
                    self.active[slot] = req
            live = [r for r in self.active if r is not None]
            if self._g_queue is not None:
                self._g_queue.set(len(self.queue))
                self._g_slots.set(len(live))
        if not live:
            return []
        if self.ms_per_token > 0:
            time.sleep(self.ms_per_token / 1e3)  # one shared "decode tick"
        finished: list[_SynRequest] = []
        with self._lock:
            for slot, r in enumerate(self.active):
                if r is None:
                    continue
                expected = expected_synthetic_tokens(r.prompt, r.max_new)
                r.out.append(expected[len(r.out)])
                if len(r.out) >= r.max_new:
                    self.active[slot] = None
                    finished.append(r)
            if finished and self._g_slots is not None:
                self._g_slots.set(sum(r is not None for r in self.active))
        for r in finished:
            self.log.record("exit", "request", r.rid, span=r.span,
                            parent=r.parent)
        return finished


class ReplicaServer:
    """HTTP serving wrapper around an engine (real or synthetic).

    One daemon engine-loop thread owns ``step()``; HTTP handler threads
    ``submit()`` (both engines are submit-thread-safe) and block on a shared
    condition until the loop publishes their rid's tokens.  Each handler
    opens an ``rpc`` span under the run root; the engine's request spawn/exit
    bracket nests inside it, so the replica's trace reads rpc → request →
    prefill → dispatch.  When the front door sent an ``X-Repro-Traceparent``
    header, the rpc span carries that :class:`SpanContext` as its *remote*
    parent — ``repro_torch.trace stitch`` re-links it under the frontdoor's route
    span once both sessions are merged.

    The engine loop is the only thread that calls into the engine's device:
    ``thread_init`` runs first on it (a real engine sets its current CUDA
    device there), ``on_idle`` runs on it whenever the engine has nothing
    pending (a fleet push), and ``live`` gives ``/healthz`` its changing
    fields (launch counts, dispatch summary), which must be host counters
    only.  An exception in the loop ends the loop: waiting handlers get an
    error, ``/healthz`` says ``ok: false``, and :attr:`error` holds it.
    """

    def __init__(self, engine: Any, *, name: str, log: EventLog,
                 plane: Optional[MetricsPlane] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 info: Optional[dict[str, Any]] = None,
                 thread_init: Optional[Callable[[], None]] = None,
                 on_idle: Optional[Callable[[], None]] = None,
                 live: Optional[Callable[[], dict[str, Any]]] = None) -> None:
        self.engine = engine
        self.name = name
        self.origin = f"{name}:{os.getpid()}"
        self.log = log
        self.plane = plane
        self.info = dict(info or {})
        self.thread_init = thread_init
        self.on_idle = on_idle
        self.live = live
        self.error: Optional[str] = None
        # a real engine's vocabulary: the handler refuses a token outside it
        # (one bad prompt must not end the engine thread for every client)
        self.vocab_size: Optional[int] = getattr(getattr(engine, "cfg", None),
                                                 "vocab_size", None)
        self.completed = 0
        self._results: dict[int, Any] = {}  # rid -> finished request object
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self.run_span = 0
        self._httpd = _ReplicaHTTPServer((host, port), _ReplicaHandler)
        self._httpd.replica = self
        self._loop_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ReplicaServer":
        # long-lived run root: every request span nests under it, mirroring
        # the driver's `with lifecycle("serve_run")` envelope
        self.run_span = next_span_id()
        self.log.record("spawn", "serve_run",
                        {"replica": self.name, **self.info}, span=self.run_span)
        self._loop_thread = threading.Thread(
            target=self._engine_loop, name=f"{self.name}-engine", daemon=True)
        self._loop_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"{self.name}-http",
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
        self.log.record("exit", "serve_run",
                        {"replica": self.name, "completed": self.completed},
                        span=self.run_span)

    def _engine_loop(self) -> None:
        try:
            if self.thread_init is not None:
                self.thread_init()
            while not self._stop.is_set():
                if self.engine.pending() == 0:
                    if self.on_idle is not None:
                        self.on_idle()
                    with self._cond:
                        self._cond.wait(timeout=0.02)
                    continue
                finished = self.engine.step()
                if finished:
                    now = time.monotonic()
                    with self._cond:
                        for r in finished:
                            r.t_done = now  # plain dataclasses: setattr is fine
                            self._results[r.rid] = r
                            self.completed += 1
                        self._cond.notify_all()
        except BaseException as exc:  # a failed build or launch ends the replica
            self.error = f"{type(exc).__name__}: {exc}"
            print(f"replica {self.name}: engine loop failed: {self.error}",
                  file=sys.stderr, flush=True)
            self._stop.set()
            with self._cond:
                self._cond.notify_all()

    def submit_and_wait(self, prompt: list[int], max_new: int,
                        timeout_s: float = 120.0,
                        ctx: Optional[SpanContext] = None,
                        ) -> tuple[int, list[int], dict[str, Any]]:
        """Submit one request, block for its tokens; returns ``(rid, tokens,
        meta)`` where ``meta`` carries the rpc span id plus the queue/service
        split (``queue_ms`` = submit → decode-slot admission, ``service_ms``
        = admission → final token) the front door folds into its per-hop
        latency decomposition.
        """
        t_sub = time.monotonic()
        payload: dict[str, Any] = {"replica": self.name}
        if ctx is not None:
            payload["trace"] = ctx.trace
            payload["remote"] = ctx.to_payload()
        # the rpc span is this process's anchor for the cross-process chain:
        # locally it nests under the run root (single-session trees are
        # unchanged); its payload's "remote" ref names the frontdoor's route
        # span, and the engine's request bracket nests inside it
        with span_scope(self.run_span), \
                self.log.lifecycle("rpc", payload) as rpc_span:
            rid = self.engine.submit(prompt, max_new=max_new)
            with self._cond:
                self._cond.notify_all()  # wake the engine loop
                deadline = time.monotonic() + timeout_s
                while rid not in self._results:
                    if self.error is not None:
                        raise RuntimeError(f"engine failed: {self.error}")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        raise TimeoutError(
                            f"request {rid} not completed within {timeout_s}s")
                    self._cond.wait(timeout=min(remaining, 0.25))
                r = self._results.pop(rid)
            t_done = getattr(r, "t_done", time.monotonic())
            t_active = getattr(r, "t_active", 0.0) or t_done
            meta = {
                "span": rpc_span,
                "queue_ms": round(max(0.0, t_active - t_sub) * 1e3, 3),
                "service_ms": round(max(0.0, t_done - t_active) * 1e3, 3),
            }
            return rid, r.out, meta

    def health(self) -> dict[str, Any]:
        doc = {
            "ok": self.error is None,
            "replica": self.name,
            "pid": os.getpid(),
            "completed": self.completed,
            "pending": self.engine.pending(),
            **self.info,
        }
        if self.error is not None:
            doc["error"] = self.error
        if self.live is not None:
            doc.update(self.live())
        return doc


class _ReplicaHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    replica: Any = None


class _ReplicaHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    def _send(self, code: int, doc: Any) -> None:
        body = json.dumps(doc, default=repr).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        path = urlparse(self.path).path
        rep = self.server.replica
        try:
            if path == "/healthz":
                self._send(200, rep.health())
            elif path == "/metrics" and rep.plane is not None:
                body = rep.plane.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/metrics.json" and rep.plane is not None:
                self._send(200, rep.plane.snapshot())
            else:
                self._send(404, {"error": "not found"})
        except Exception as exc:
            self._send(500, {"error": repr(exc)})

    def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
        path = urlparse(self.path).path
        rep = self.server.replica
        if path != "/v1/generate":
            self._send(404, {"error": "not found"})
            return
        recv_unix = time.time()  # replica-side handshake stamp (wall clock)
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body.get("prompt")
            max_new = int(body.get("max_new", 16))
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                self._send(400, {"error": "prompt must be a non-empty list of ints"})
                return
            if max_new < 1:
                self._send(400, {"error": "max_new must be >= 1"})
                return
            if rep.vocab_size is not None and not all(0 <= t < rep.vocab_size
                                                      for t in prompt):
                self._send(400, {"error": f"prompt tokens must lie in [0, {rep.vocab_size})"})
                return
            ctx = SpanContext.extract(self.headers.get(TRACEPARENT_HEADER))
            t0 = time.perf_counter()
            rid, tokens, meta = rep.submit_and_wait(prompt, max_new, ctx=ctx)
            handler_ms = round((time.perf_counter() - t0) * 1e3, 3)
            self._send(200, {
                "rid": rid,
                "tokens": tokens,
                "replica": rep.name,
                "latency_ms": handler_ms,
                # everything the front door needs to decompose this hop and
                # to skew-correct this replica's clock at stitch time
                "ctx": {
                    "origin": rep.origin,
                    "span": meta["span"],
                    "trace": ctx.trace if ctx else None,
                    "recv_unix": recv_unix,
                    "sent_unix": time.time(),
                    "handler_ms": handler_ms,
                    "queue_ms": meta["queue_ms"],
                    "service_ms": meta["service_ms"],
                },
            })
        except TimeoutError as exc:
            self._send(504, {"error": str(exc)})
        except Exception as exc:
            self._send(500, {"error": repr(exc)})


def _build_real_engine(args: argparse.Namespace, log: EventLog,
                       plane: MetricsPlane) -> tuple[Any, dict[str, Any], dict[str, Any]]:
    """The port's compiled Engine on ``--device``, built as ``launch.serve``
    builds it (imports deferred: synthetic replicas and the router process
    never import ``torch``).  Returns the engine, its identity for the ready
    file and the :class:`ReplicaServer` hooks (``thread_init``, ``on_idle``,
    ``live``) plus the fleet pusher (``pusher``, or None) and the run's
    metadata for its streamed session (``run_meta``)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build, launch_counts
    from repro_torch.launch.serve import make_dispatcher, warm_start
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, ServeConfig

    device = resolve_device(args.device)  # no card: fails unless --device cpu
    if device.type == "cuda":
        if device.index is None:  # "cuda": the current card, named by its index
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        # build and load every kernel before the first request: a replica
        # whose kernels do not build exits non-zero here
        for name in _build.build():
            _build.load(name)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init_params(cfg, args.seed, device)
    args.profile_in = None  # the replica warm-starts from --fleet only
    dispatcher, _aged = make_dispatcher(args, device, log)
    tiers = ([t.name for t in dispatcher.registry.available(device)]
             if dispatcher is not None else [])
    info: dict[str, Any] = {"arch": cfg.name, "device": str(device)}
    run_meta: dict[str, Any] = {}
    fleet_rec, pusher = warm_start(args, dispatcher, run_meta)
    if dispatcher is not None:
        info["chip"] = dispatcher.chip.name
    if fleet_rec is not None:
        info["fleet"] = fleet_rec
    engine = Engine(
        cfg, params,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                    seed=args.seed),
        log=log, dispatcher=dispatcher, metrics=plane.registry,
        # the engine's bound of prefill graphs for each tier it serves
        max_prefill_graphs=PREFILL_GRAPHS_PER_TIER * max(1, len(tiers)))

    def thread_init() -> None:
        if device.type == "cuda":
            torch.cuda.set_device(device)

    last_push = [time.monotonic()]

    def on_idle() -> None:
        # on the engine thread, between steps: the store is not being written
        if pusher is not None and time.monotonic() - last_push[0] >= FLEET_PUSH_S:
            last_push[0] = time.monotonic()
            pusher.push()

    def live() -> dict[str, Any]:
        doc: dict[str, Any] = {"kernels": launch_counts()}
        if dispatcher is not None:
            doc["dispatch"] = dispatcher.summary()
            doc["explore_events"] = sum(
                1 for e in log.events(kind="dispatch")
                if isinstance(e.payload, dict) and e.payload.get("source") == "explore")
            doc["tiers"] = sorted(tiers)
        if pusher is not None:
            doc["fleet_pushed_samples"] = pusher.pushed_samples
        return doc

    hooks = {"thread_init": thread_init, "on_idle": on_idle, "live": live,
             "pusher": pusher, "run_meta": run_meta}
    return engine, info, hooks


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.router.replica", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", default=f"replica-{os.getpid()}")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (announced via --ready-file)")
    ap.add_argument("--ready-file", default=None, metavar="PATH",
                    help="announce the bound URL + identity here once serving")
    ap.add_argument("--synthetic", action="store_true",
                    help="deterministic no-accelerator engine (tests)")
    ap.add_argument("--synthetic-ms-per-token", type=float, default=2.0,
                    metavar="MS", help="synthetic decode-tick sleep")
    ap.add_argument("--arch", default=None,
                    help="model config for a real engine (required unless "
                         "--synthetic)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--dispatch",
                    choices=("off", "static", "roofline", "profiled"),
                    default="off")
    ap.add_argument("--dispatch-backend", default="kernel",
                    help="tier pinned by --dispatch static (kernel or plain)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of a real engine; 'cpu' runs the plain "
                         "PyTorch versions")
    ap.add_argument("--fleet", default=None, metavar="URL|DIR",
                    help="warm-start dispatch profiles from a fleet target "
                         "and push measured deltas to it (when the engine is "
                         f"idle, at most every {FLEET_PUSH_S:g} s, and at exit)")
    ap.add_argument("--fleet-token", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir-root", default=None, metavar="DIR",
                    help="stream this replica's trace into DIR/<name>-<pid>/ "
                         "(a fresh dir per incarnation so supervisor restarts "
                         "never collide); the dir is announced in the ready "
                         "file for `repro_torch.trace stitch` auto-discovery")
    ap.add_argument("--trace-rotate", type=int, default=2048, metavar="N",
                    help="events per streamed segment")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.arch:
        ap.error("--arch is required unless --synthetic")

    from repro_torch.hw.specs import default_chip
    from repro_torch.trace.session import git_sha

    log = TraceCollector()
    plane = MetricsPlane(log)
    hooks: dict[str, Any] = {}
    if args.synthetic:
        engine: Any = SyntheticEngine(
            max_batch=args.max_batch,
            ms_per_token=args.synthetic_ms_per_token,
            log=log, metrics=plane.registry)
        info: dict[str, Any] = {"chip": default_chip().name}
    else:
        engine, info, hooks = _build_real_engine(args, log, plane)
        info.setdefault("chip", default_chip().name)
    pusher = hooks.pop("pusher", None)
    run_meta = hooks.pop("run_meta", {})
    info.update({"git_sha": git_sha(), "synthetic": bool(args.synthetic)})

    stream = None
    if args.trace_dir_root:
        from repro_torch.trace.stream import StreamingSession

        trace_dir = os.path.join(args.trace_dir_root,
                                 f"{args.name}-{os.getpid()}")
        stream = StreamingSession(
            trace_dir, rotate_events=args.trace_rotate,
            meta={"driver": "replica", "replica": args.name,
                  "origin": f"{args.name}:{os.getpid()}", **run_meta},
            metrics_provider=plane.snapshot,
        ).attach(log)
        info["trace_dir"] = trace_dir

    server = ReplicaServer(engine, name=args.name, log=log, plane=plane,
                           host=args.host, port=args.port, info=info,
                           **hooks).start()
    announce = {"url": server.url, "pid": os.getpid(), "name": args.name,
                **info}
    print(json.dumps({"replica": args.name, **announce}), flush=True)
    if args.ready_file:
        write_ready_file(args.ready_file, announce)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.is_set() and server.error is None:
        stop.wait(0.2)
    server.stop()
    done: dict[str, Any] = {"replica": args.name, "completed": server.completed,
                            "shutdown": True}
    if pusher is not None:
        final = pusher.push()  # the rest of the delta, after the engine stopped
        done["fleet_pushed_samples"] = pusher.pushed_samples
        if "error" in final:
            done["fleet_push_error"] = final["error"]
    if stream is not None:
        stream.close(stats=log.stats())
    if server.error is not None:
        done["error"] = server.error
    print(json.dumps(done), file=sys.stderr, flush=True)
    return 1 if server.error is not None else 0


if __name__ == "__main__":
    sys.exit(main())
