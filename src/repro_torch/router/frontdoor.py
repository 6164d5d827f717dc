"""The router's front door: one HTTP listener, exactly-once forwarding
(counterpart of ``repro/router/frontdoor.py``: the same wire format, the
same ``X-Repro-Traceparent`` header and the same accounting).

``POST /v1/generate`` runs the full request pipeline inside a ``request``
span parented under the router's run root:

1. classify (:func:`repro_torch.router.cost.class_of`) and **route** — each
   routing decision is recorded as a ``route`` event parented under the
   request span, mirroring how dispatch decisions nest under the op that
   triggered them;
2. **forward** to the chosen replica.  A connection-level failure
   (refused / reset / replica hung up mid-response) means the replica died
   with the request in flight: mark it down, pick another replica, retry —
   the drain-then-retry path that makes a SIGKILLed replica invisible to
   clients.  Admission control stays honest across retries (``begin``/``end``
   bracket every attempt);
3. account the terminal ``outcome`` event (``ok`` / ``retried`` /
   ``rejected`` / ``error``) that the metrics sink folds into
   ``repro_router_requests_total{replica,outcome}`` and
   ``repro_router_route_ms`` — every request gets exactly one.

``GET /healthz`` reports router totals plus per-replica manager state (tests
read pids out of it to aim their SIGKILL); ``/metrics`` + ``/metrics.json``
expose the router's metrics plane on the same port.
"""
from __future__ import annotations

import http.client
import json
import os
import socket
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from repro_torch.core.events import SpanContext, TRACEPARENT_HEADER, next_span_id
from repro_torch.router.cost import NoReplicaAvailable, RouterBusy, class_of

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ReplicaDead(RuntimeError):
    """Connection-level forward failure: the replica process is gone."""


class ForwardFailed(RuntimeError):
    """The replica answered, but with an error/timeout — do not mark it dead."""


def forward_generate(url: str, body: bytes, timeout_s: float,
                     headers: Optional[dict[str, str]] = None) -> dict[str, Any]:
    """POST one generate request to a replica, classifying failures.

    :class:`ReplicaDead` is raised only for failures that prove the process
    is unreachable (refused/reset/hung-up) — those are safe to drain-retry
    on another replica.  Anything else (HTTP error, timeout with the
    connection still up) raises :class:`ForwardFailed`: the replica may
    still be computing, so retrying elsewhere risks double work, and the
    supervisor's healthz probing owns the wedged-replica call.

    ``headers`` adds extra request headers — the front door passes the
    ``X-Repro-Traceparent`` span context here.
    """
    req = urllib.request.Request(
        f"{url}/v1/generate", data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        raise ForwardFailed(f"replica HTTP {exc.code}") from exc
    except (ConnectionRefusedError, ConnectionResetError, BrokenPipeError,
            http.client.RemoteDisconnected) as exc:
        raise ReplicaDead(f"{type(exc).__name__}: {exc}") from exc
    except urllib.error.URLError as exc:
        reason = getattr(exc, "reason", None)
        if isinstance(reason, (ConnectionRefusedError, ConnectionResetError,
                               BrokenPipeError, http.client.RemoteDisconnected)):
            raise ReplicaDead(f"{type(reason).__name__}: {reason}") from exc
        raise ForwardFailed(f"URLError: {reason}") from exc
    except (http.client.HTTPException, socket.timeout, TimeoutError,
            OSError) as exc:
        raise ForwardFailed(f"{type(exc).__name__}: {exc}") from exc


class FrontDoorServer(ThreadingHTTPServer):
    """Router-owned listener; handler threads read shared state off it."""

    daemon_threads = True
    allow_reuse_address = True
    # injected by repro_torch.router.cli before serve_forever
    log: Any = None
    router: Any = None
    manager: Any = None
    plane: Any = None
    run_span: int = 0
    forward_timeout_s: float = 120.0
    request_timeout_s: float = 30.0  # budget for finding a live replica
    requests_seen: int = 0
    origin: str = ""  # process identity stamped into injected SpanContexts

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self.shutdown()
        self.server_close()


class FrontDoorHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    def _send(self, code: int, doc: Any,
              headers: Optional[dict[str, str]] = None) -> None:
        body = json.dumps(doc, default=repr).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- GET: health + metrics -------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        path = urlparse(self.path).path
        srv = self.server
        try:
            if path == "/healthz":
                self._send(200, {
                    "ok": True,
                    "requests": srv.requests_seen,
                    "router": srv.router.snapshot(),
                    "replicas": srv.manager.status(),
                })
            elif path == "/metrics":
                body = srv.plane.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROM_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/metrics.json":
                self._send(200, srv.plane.snapshot())
            else:
                self._send(404, {"error": "not found"})
        except Exception as exc:
            self._send(500, {"error": repr(exc)})

    # -- POST: the routed request pipeline ------------------------------------

    def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
        if urlparse(self.path).path != "/v1/generate":
            self._send(404, {"error": "not found"})
            return
        srv = self.server
        try:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) or b"{}"
            body = json.loads(raw)
            prompt = body.get("prompt")
            max_new = int(body.get("max_new", 16))
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                self._send(400, {"error": "prompt must be a non-empty list of ints"})
                return
        except (ValueError, TypeError) as exc:
            self._send(400, {"error": f"bad request body: {exc}"})
            return
        srv.requests_seen += 1
        self._route_and_forward(srv, raw, prompt, max_new)

    def _route_and_forward(self, srv: FrontDoorServer, raw: bytes,
                           prompt: list[int], max_new: int) -> None:
        log, router = srv.log, srv.router
        cls = class_of(len(prompt), max_new)
        origin = srv.origin or f"frontdoor:{os.getpid()}"
        trace_id = uuid.uuid4().hex[:16]
        t_req0 = time.perf_counter()
        route_ms = 0.0
        attempts = 0
        deadline = time.monotonic() + srv.request_timeout_s

        def outcome(name: str, replica: str, rspan: int,
                    **extra: Any) -> dict[str, Any]:
            payload = {
                "replica": replica, "outcome": name, "class": cls,
                "route_ms": round(route_ms, 4),
                "latency_ms": round((time.perf_counter() - t_req0) * 1e3, 3),
                "attempts": attempts, **extra,
            }
            log.record("route", "outcome", payload, parent=rspan)
            return payload

        with log.lifecycle("request", {"class": cls, "trace": trace_id},
                           parent=srv.run_span) as rspan:
            while True:
                t0 = time.perf_counter()
                try:
                    decision = router.route(cls)
                except RouterBusy as exc:
                    route_ms += (time.perf_counter() - t0) * 1e3
                    p = outcome("rejected", "-", rspan, error=str(exc))
                    self._send(429, {"error": str(exc), **p})
                    return
                except NoReplicaAvailable as exc:
                    route_ms += (time.perf_counter() - t0) * 1e3
                    if time.monotonic() >= deadline:
                        p = outcome("error", "-", rspan, error=str(exc))
                        self._send(503, {"error": str(exc), **p})
                        return
                    time.sleep(0.05)  # replicas mid-restart: wait, re-route
                    continue
                route_ms += (time.perf_counter() - t0) * 1e3
                # the per-attempt route decision gets its own span id so the
                # replica's rpc span can name it as a remote parent; the
                # injected SpanContext's sent_unix + the reply's wall stamps
                # form the handshake pair stitch uses to estimate clock skew
                route_span = next_span_id()
                log.record("route", "route",
                           {**decision.payload(), "trace": trace_id},
                           span=route_span, parent=rspan)
                ctx = SpanContext(trace=trace_id, span=route_span,
                                  origin=origin, sent_unix=time.time())
                router.begin(decision.replica)
                t_fwd = time.perf_counter()
                try:
                    reply = forward_generate(decision.url, raw,
                                             srv.forward_timeout_s,
                                             headers={TRACEPARENT_HEADER:
                                                      ctx.inject()})
                except ReplicaDead as exc:
                    router.end(decision.replica)
                    router.fail(decision.replica, dead=True)
                    attempts += 1
                    log.record("mark", "replica",
                               {"replica": decision.replica, "state": "dead-on-forward",
                                "error": str(exc)}, parent=rspan)
                    if time.monotonic() >= deadline:
                        p = outcome("error", decision.replica, rspan,
                                    error=str(exc))
                        self._send(503, {"error": str(exc), **p})
                        return
                    continue  # drain-then-retry on another replica
                except ForwardFailed as exc:
                    router.end(decision.replica)
                    router.fail(decision.replica)
                    attempts += 1
                    if time.monotonic() >= deadline:
                        p = outcome("error", decision.replica, rspan,
                                    error=str(exc))
                        self._send(502, {"error": str(exc), **p})
                        return
                    continue
                recv_unix = time.time()
                service_s = time.perf_counter() - t_fwd
                router.end(decision.replica)
                router.complete(decision.replica, cls, service_s)
                extra = self._hop_extra(reply, ctx, recv_unix,
                                        fwd_ms=service_s * 1e3,
                                        lat_ms=(time.perf_counter() - t_req0) * 1e3)
                p = outcome("retried" if attempts else "ok",
                            decision.replica, rspan, **extra)
                self._send(200, {**reply, "routed_to": decision.replica,
                                 "outcome": p["outcome"],
                                 "route_ms": p["route_ms"],
                                 "attempts": attempts,
                                 "trace": trace_id,
                                 "hops": p.get("hops")},
                           headers={"X-Repro-Replica": decision.replica,
                                    "X-Repro-Route-Ms": str(p["route_ms"])})
                return

    @staticmethod
    def _hop_extra(reply: dict[str, Any], ctx: SpanContext, recv_unix: float,
                   *, fwd_ms: float, lat_ms: float) -> dict[str, Any]:
        """Per-hop latency decomposition + the clock-skew handshake record.

        The four hops telescope — ``frontdoor_queue = latency - forward``,
        ``network = forward - handler``, ``replica_queue = handler -
        service`` — so their sum equals the end-to-end latency *by
        construction*, using only single-clock durations (each term is
        measured within one process; no cross-host clock appears).  ``hs``
        carries the four wall timestamps of the forward round trip
        (frontdoor send/recv, replica recv/send) for stitch's NTP-style
        offset estimate.
        """
        extra: dict[str, Any] = {"latency_ms": round(lat_ms, 3)}
        rctx = reply.get("ctx")
        if not isinstance(rctx, dict):
            return extra  # pre-tracing replica: no decomposition possible
        try:
            handler_ms = float(rctx["handler_ms"])
            service_ms = float(rctx["service_ms"])
        except (KeyError, TypeError, ValueError):
            return extra
        extra["hops"] = {
            "frontdoor_queue": round(lat_ms - fwd_ms, 3),
            "network": round(fwd_ms - handler_ms, 3),
            "replica_queue": round(handler_ms - service_ms, 3),
            "service": round(service_ms, 3),
        }
        extra["hs"] = {
            "origin": rctx.get("origin"), "span": rctx.get("span"),
            "trace": ctx.trace,
            "sent_unix": ctx.sent_unix, "recv_unix": recv_unix,
            "replica_recv_unix": rctx.get("recv_unix"),
            "replica_sent_unix": rctx.get("sent_unix"),
        }
        return extra


def make_frontdoor(host: str = "127.0.0.1", port: int = 0) -> FrontDoorServer:
    return FrontDoorServer((host, port), FrontDoorHandler)
