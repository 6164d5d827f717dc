"""Fleet profile daemon: a stdlib ``http.server`` front end over FleetStore
(counterpart of ``repro/fleet/service.py``, on the port's metrics registry).

No third-party dependencies — a ``ThreadingHTTPServer`` speaking a small
JSON protocol (one route per :class:`~repro_torch.fleet.store.FleetStore` verb):

    GET  /healthz                          liveness + bucket count + stats
    GET  /metrics                          Prometheus text (same counters)
    GET  /v1/ls                            bucket metadata listing
    GET  /v1/pull?git_sha=S&chip=C         best match (exact → chip → miss)
    POST /v1/push   {git_sha, chip, store} Welford-merge a snapshot in
    POST /v1/gc     {max_age_s, keep_per_chip}

Run it with ``python -m repro_torch.fleet serve --root DIR``; talk to it with
:class:`~repro_torch.fleet.client.FleetClient` (which also speaks directly to a
store directory for single-host use — same verbs, no daemon).

``--token T`` turns on write authentication: push and gc (the mutating
verbs) then require ``Authorization: Bearer T``; pull/ls/healthz stay open
— a shared fleet wants everyone warm-starting but only trusted runs feeding
the Welford state.  Rejections are 401s, counted in the daemon's stats
(``auth_failures`` in ``/healthz``).

``--quota-rps R`` adds per-source rate quotas on the same mutating verbs: a
token bucket per client address (refill R req/s, capacity ``--quota-burst``)
so one chatty replica can't starve the rest of the fleet's writers.  Over-
quota requests get 429, counted as ``throttled``; each throttle *episode*
(the transition into denial, not every denied request) lands in
``AUDIT.jsonl``.

``/healthz`` and ``/metrics`` read the **same**
:class:`~repro_torch.metrics.registry.MetricsRegistry` counters — there is one
counter source, so the two surfaces can never drift apart.

Every successful mutating verb is also appended to ``AUDIT.jsonl`` in the
store root — who (source address + a token digest, never the token itself)
changed what (git_sha/chip/sample counts for push, removal count for gc)
and when.  ``python -m repro_torch.fleet audit --root DIR`` tails it.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.fleet.store import FleetStore
from repro_torch.metrics.http import PROM_CONTENT_TYPE
from repro_torch.metrics.registry import MetricsRegistry

MAX_PUSH_BYTES = 64 << 20  # a merged ProfileStore is KBs; 64 MiB is generous

AUDIT_NAME = "AUDIT.jsonl"  # one JSON record per successful push/gc


def read_audit(root: str, n: Optional[int] = None) -> list[dict[str, Any]]:
    """The last ``n`` audit records of a fleet store (all when ``n`` is
    None); missing file means no mutations yet, not an error.  Torn final
    lines (daemon killed mid-append) are skipped."""
    path = os.path.join(root, AUDIT_NAME)
    if not os.path.exists(path):
        return []
    out: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out[-n:] if n is not None else out

# Daemon verb counters; /healthz reports them under these short keys, the
# Prometheus surface as repro_fleet_<key>_total — same Counter objects.
STAT_KEYS = ("pushes", "pulls", "gcs", "auth_failures", "throttled")


class RateQuota:
    """Per-source token bucket over the mutating verbs (push/gc).

    One bucket per client address: refill ``rps`` tokens/s up to ``burst``
    capacity, one token per request.  ``allow`` returns ``(allowed,
    episode_start)`` — the second flag is True only on the transition into
    denial, so callers can audit one record per throttle episode instead of
    one per denied request (a runaway client would otherwise flood the very
    audit log the quota protects).

    ``clock`` is injectable (tests pass a fake monotonic clock).  The bucket
    table is LRU-bounded: address churn (NAT pools, short-lived replicas) can't
    grow it without bound, and an evicted source simply restarts with a full
    bucket — the quota fails open, never spuriously throttles.
    """

    def __init__(self, rps: float, burst: Optional[float] = None, *,
                 clock: Any = time.monotonic, max_sources: int = 1024) -> None:
        if rps <= 0:
            raise ValueError(f"quota rps must be positive, got {rps}")
        self.rps = float(rps)
        self.burst = float(burst) if burst is not None else max(1.0, self.rps)
        if self.burst < 1.0:
            raise ValueError(f"quota burst must be >= 1, got {self.burst}")
        self.clock = clock
        self.max_sources = max_sources
        self._lock = threading.Lock()
        # source -> (tokens, t_last); insertion order is recency (pop+reinsert)
        self._buckets: dict[str, tuple[float, float]] = {}
        self._throttled: set[str] = set()

    def allow(self, source: str) -> tuple[bool, bool]:
        now = self.clock()
        with self._lock:
            tokens, last = self._buckets.pop(source, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rps)
            allowed = tokens >= 1.0
            if allowed:
                tokens -= 1.0
            self._buckets[source] = (tokens, now)
            while len(self._buckets) > self.max_sources:
                evicted = next(iter(self._buckets))
                del self._buckets[evicted]
                self._throttled.discard(evicted)
            if allowed:
                self._throttled.discard(source)
                return True, False
            episode_start = source not in self._throttled
            self._throttled.add(source)
            return False, episode_start


class FleetServer(ThreadingHTTPServer):
    """HTTP server owning one FleetStore (threaded: pushes serialize on the
    store's lock, reads are cheap).  ``token`` guards the mutating verbs."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr: tuple[str, int], fleet: FleetStore,
                 quiet: bool = True, token: Optional[str] = None,
                 quota: Optional[RateQuota] = None) -> None:
        self.fleet = fleet
        self.quiet = quiet
        self.token = token
        self.quota = quota
        self.audit_path = os.path.join(fleet.root, AUDIT_NAME)
        self._audit_lock = threading.Lock()
        # single counter source for /healthz AND /metrics: a parallel dict
        # would inevitably drift from the scraped series
        self.metrics = MetricsRegistry()
        for key in STAT_KEYS:
            self.metrics.counter(f"repro_fleet_{key}_total",
                                 f"fleet daemon {key.replace('_', ' ')}")
        super().__init__(addr, _Handler)

    def count(self, key: str) -> None:
        self.metrics.counter(f"repro_fleet_{key}_total").inc()

    def audit(self, verb: str, addr: str, **fields: Any) -> None:
        """Append one audit record for a successful mutating verb.

        The token is recorded as a short sha256 digest — enough to tell two
        writers apart without persisting the secret itself.  Append + flush
        per record: a killed daemon loses at most its torn final line
        (which ``read_audit`` skips).
        """
        rec: dict[str, Any] = {"t": round(time.time(), 3), "verb": verb,
                               "addr": addr}
        if self.token is not None:
            rec["token_sha"] = hashlib.sha256(
                self.token.encode()).hexdigest()[:12]
        rec.update({k: v for k, v in fields.items() if v is not None})
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._audit_lock, open(self.audit_path, "a") as f:
            f.write(line)
            f.flush()

    def stats_snapshot(self) -> dict[str, int]:
        return {key: int(self.metrics.counter(f"repro_fleet_{key}_total").value)
                for key in STAT_KEYS}

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        if host in ("0.0.0.0", "::"):  # wildcard binds aren't connectable —
            # give scripts/--ready-file consumers a reachable name
            import socket

            host = socket.getfqdn() or socket.gethostname()
        return f"http://{host}:{port}"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-fleet/1"
    server: FleetServer  # narrowed for the route handlers

    # -- plumbing -------------------------------------------------------------

    def log_message(self, fmt: str, *args: Any) -> None:
        if not self.server.quiet:
            sys.stderr.write("fleet: " + (fmt % args) + "\n")

    def _send(self, code: int, doc: dict[str, Any]) -> None:
        body = json.dumps(doc, indent=1).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str, ctype: str) -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _error(self, code: int, message: str) -> None:
        self._send(code, {"error": message})

    def _body(self) -> Optional[dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            n = 0
        if n <= 0 or n > MAX_PUSH_BYTES:
            self._error(400, f"body required (≤ {MAX_PUSH_BYTES} bytes)")
            return None
        try:
            doc = json.loads(self.rfile.read(n))
        except json.JSONDecodeError as exc:
            self._error(400, f"invalid JSON body: {exc}")
            return None
        if not isinstance(doc, dict):
            self._error(400, "body must be a JSON object")
            return None
        return doc

    def _authorized(self) -> bool:
        """Bearer check for the mutating verbs (push/gc).  Open when the
        daemon runs without --token; 401s are counted in the daemon stats."""
        token = self.server.token
        if token is None:
            return True
        header = self.headers.get("Authorization", "")
        # compare bytes: compare_digest raises TypeError on non-ASCII str,
        # and HTTP headers arrive latin-1 decoded
        if hmac.compare_digest(header.encode("latin-1", "replace"),
                               f"Bearer {token}".encode("latin-1", "replace")):
            return True
        self.server.count("auth_failures")
        self._error(401, "push/gc require 'Authorization: Bearer <token>' "
                         "(daemon started with --token)")
        return False

    def _within_quota(self, path: str) -> bool:
        """Per-source token bucket on the mutating verbs (after auth, so
        unauthenticated floods are 401s, not quota spend).  Denials are 429,
        counted; each throttle episode gets exactly one audit record."""
        quota = self.server.quota
        if quota is None:
            return True
        source = self.client_address[0]
        allowed, episode_start = quota.allow(source)
        if allowed:
            return True
        self.server.count("throttled")
        if episode_start:
            self.server.audit("throttle", source, path=path,
                              rps=quota.rps, burst=quota.burst)
        self._error(429, f"per-source rate quota exceeded "
                         f"({quota.rps:g} req/s, burst {quota.burst:g})")
        return False

    # -- routes ---------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        url = urllib.parse.urlsplit(self.path)
        q = urllib.parse.parse_qs(url.query)
        try:
            if url.path == "/healthz":
                self._send(200, {"ok": True, "schema": "repro.fleet/v1",
                                 "snapshots": len(self.server.fleet),
                                 "auth": self.server.token is not None,
                                 "stats": self.server.stats_snapshot()})
            elif url.path == "/metrics":
                # same registry /healthz reads — one counter source, no drift
                self.server.metrics.gauge(
                    "repro_fleet_snapshots",
                    "profile snapshots held by the store").set(len(self.server.fleet))
                self._send_text(200, self.server.metrics.render(),
                                PROM_CONTENT_TYPE)
            elif url.path == "/v1/ls":
                self._send(200, {"snapshots": self.server.fleet.ls()})
            elif url.path == "/v1/pull":
                git_sha = (q.get("git_sha") or [""])[0]
                chip = (q.get("chip") or [""])[0]
                if not git_sha or not chip:
                    self._error(400, "pull requires git_sha= and chip= params")
                    return
                self.server.count("pulls")
                self._send(200, self.server.fleet.pull(git_sha, chip))
            else:
                self._error(404, f"unknown path {url.path}")
        except Exception as exc:  # surface the failure to the client, not a 500 page
            self._error(500, f"{type(exc).__name__}: {exc}")

    def do_POST(self) -> None:  # noqa: N802
        url = urllib.parse.urlsplit(self.path)
        if url.path in ("/v1/push", "/v1/gc"):
            if not self._authorized():
                return
            if not self._within_quota(url.path):
                return
        body = self._body()
        if body is None:
            return
        try:
            if url.path == "/v1/push":
                git_sha = body.get("git_sha", "")
                chip = body.get("chip", "")
                raw = body.get("store")
                if not isinstance(raw, dict) or "entries" not in raw:
                    self._error(400, "push body needs a 'store' ProfileStore object")
                    return
                store = ProfileStore.from_json(json.dumps(raw))
                self.server.count("pushes")
                res = self.server.fleet.push(
                    store, git_sha, chip,
                    source=body.get("source"), seq=body.get("seq"))
                self.server.audit(
                    "push", self.client_address[0],
                    git_sha=git_sha, chip=chip, source=body.get("source"),
                    entries=len(store),
                    merged_samples=res.get("merged_samples")
                    if isinstance(res, dict) else None)
                self._send(200, res)
            elif url.path == "/v1/gc":
                self.server.count("gcs")
                removed = self.server.fleet.gc(
                    max_age_s=body.get("max_age_s"),
                    keep_per_chip=body.get("keep_per_chip"),
                )
                self.server.audit(
                    "gc", self.client_address[0],
                    max_age_s=body.get("max_age_s"),
                    keep_per_chip=body.get("keep_per_chip"), removed=removed)
                self._send(200, {"removed": removed})
            else:
                self._error(404, f"unknown path {url.path}")
        except (ValueError, KeyError, TypeError) as exc:
            self._error(400, f"{type(exc).__name__}: {exc}")
        except Exception as exc:
            self._error(500, f"{type(exc).__name__}: {exc}")


def make_server(root: str, host: str = "127.0.0.1", port: int = 8377,
                quiet: bool = True, token: Optional[str] = None,
                quota_rps: Optional[float] = None,
                quota_burst: Optional[float] = None) -> FleetServer:
    """Bind a fleet daemon (``port=0`` picks a free port; see ``.url``).

    ``token`` requires ``Authorization: Bearer <token>`` on push/gc.
    ``quota_rps`` rate-limits push/gc per source address (token bucket of
    ``quota_burst`` capacity, default max(1, rps)); over-quota gets 429.
    """
    import os

    os.makedirs(root, exist_ok=True)  # the daemon's root is explicit intent
    quota = RateQuota(quota_rps, quota_burst) if quota_rps is not None else None
    return FleetServer((host, port), FleetStore(root), quiet=quiet, token=token,
                       quota=quota)
