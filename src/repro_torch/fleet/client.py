"""FleetClient + FleetPusher: the run-side half of the fleet profile service
(counterpart of ``repro/fleet/client.py``, over the port's ``ProfileStore``).

``FleetClient`` speaks the same verbs (push/pull/ls/gc) to either transport:

* ``http://host:port`` — the :mod:`repro_torch.fleet.service` daemon;
* ``file:///path`` or a plain directory path — direct
  :class:`~repro_torch.fleet.store.FleetStore` access for single-host fleets
  (no daemon, same on-disk format, advisory-locked).

``FleetPusher`` is the incremental feeder a long-lived run attaches to its
:class:`~repro_torch.trace.stream.StreamingSession`: every rotation it pushes only
the samples recorded *since its last push* (``ProfileStore.delta_since``), so
repeated pushes never double-count in the fleet's Welford merge.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.fleet.store import FleetStore


class FleetError(RuntimeError):
    """The fleet target is unreachable or rejected the request."""


def _parse_target(target: str) -> tuple[str, str]:
    """('http', url) for daemon targets; ('file', path) for direct mode."""
    if target.startswith(("http://", "https://")):
        return "http", target.rstrip("/")
    if target.startswith("file://"):
        return "file", urllib.request.url2pathname(
            urllib.parse.urlsplit(target).path)
    return "file", target


class FleetClient:
    """Push/pull/ls/gc against an HTTP daemon or a store directory.

    ``token`` is sent as ``Authorization: Bearer <token>`` on every HTTP
    request — daemons started with ``--token`` require it on push/gc.
    Direct (file) mode ignores it: whoever can open the store directory
    already has write access.
    """

    def __init__(self, target: str, timeout: float = 10.0,
                 token: Optional[str] = None) -> None:
        self.target = target
        self.timeout = timeout
        self.token = token
        self.mode, loc = _parse_target(target)
        self._url: Optional[str] = loc if self.mode == "http" else None
        self._store: Optional[FleetStore] = (
            FleetStore(loc) if self.mode == "file" else None
        )

    # -- transport ------------------------------------------------------------

    def _direct(self, fn: Any, *args: Any, **kwargs: Any) -> Any:
        """File-mode verb with I/O failures normalised to FleetError, so
        callers (FleetPusher, warm_start_from_fleet, the drivers) handle a
        full disk or permission error the same as an unreachable daemon —
        log/degrade, never crash the traced run."""
        try:
            return fn(*args, **kwargs)
        except OSError as exc:
            raise FleetError(
                f"fleet {self.target}: {type(exc).__name__}: {exc}") from exc

    def _request(self, method: str, path: str,
                 body: Optional[dict[str, Any]] = None) -> dict[str, Any]:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            f"{self._url}{path}", data=data, method=method, headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                detail = json.loads(exc.read()).get("error", "")
            except Exception:
                detail = ""
            raise FleetError(
                f"fleet {self.target}{path}: HTTP {exc.code}"
                + (f" ({detail})" if detail else "")
            ) from exc
        except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as exc:
            raise FleetError(f"fleet {self.target} unreachable: {exc}") from exc

    # -- verbs ----------------------------------------------------------------

    def push(self, store: ProfileStore, git_sha: str, chip: str,
             source: Optional[str] = None, seq: Optional[int] = None) -> dict[str, Any]:
        """Merge a snapshot into the fleet.  ``(source, seq)`` lets retrying
        callers make the push idempotent (see :meth:`FleetStore.push`)."""
        if self.mode == "file":
            return self._direct(self._store.push, store, git_sha, chip,
                                source=source, seq=seq)
        body: dict[str, Any] = {
            "git_sha": git_sha, "chip": chip,
            "store": json.loads(store.to_json()),
        }
        if source is not None:
            body["source"] = source
            body["seq"] = seq
        return self._request("POST", "/v1/push", body)

    def pull(self, git_sha: str, chip: str) -> dict[str, Any]:
        """Best-match pull; ``result["store"]`` is a ProfileStore or None."""
        if self.mode == "file":
            out = dict(self._direct(self._store.pull, git_sha, chip))
        else:
            out = self._request(
                "GET",
                "/v1/pull?" + urllib.parse.urlencode(
                    {"git_sha": git_sha, "chip": chip}),
            )
        raw = out.get("store")
        out["store"] = ProfileStore.from_json(json.dumps(raw)) if raw else None
        return out

    def ls(self) -> list[dict[str, Any]]:
        if self.mode == "file":
            return self._direct(self._store.ls)
        return self._request("GET", "/v1/ls")["snapshots"]

    def gc(self, max_age_s: Optional[float] = None,
           keep_per_chip: Optional[int] = None) -> list[dict[str, Any]]:
        if self.mode == "file":
            return self._direct(self._store.gc, max_age_s=max_age_s,
                                keep_per_chip=keep_per_chip)
        return self._request("POST", "/v1/gc", {
            "max_age_s": max_age_s, "keep_per_chip": keep_per_chip,
        })["removed"]

    def health(self) -> dict[str, Any]:
        if self.mode == "file":
            return {"ok": True, "snapshots": self._direct(len, self._store)}
        return self._request("GET", "/healthz")


class FleetPusher:
    """Incremental (delta-based) pusher bound to one live ProfileStore.

    The baseline snapshot is taken at construction, so create the pusher
    *after* merging any pulled fleet profiles into the store — otherwise the
    first push would echo the fleet's own samples back at it.  ``push()`` is
    thread-safe (streaming rotations happen on whichever thread tripped the
    rotation budget) and best-effort by default: an unreachable fleet leaves
    the baseline untouched, so the missed samples ride the next push.

    Pushes are **exactly-once**: each carries a per-pusher source id and a
    sequence number, and an in-flight delta is retried verbatim (same seq)
    until the fleet acknowledges it — so a push that *landed* but whose
    response was lost (timeout) is deduped server-side instead of being
    Welford-merged twice.  Samples recorded while a delta is pending ride
    the next one.
    """

    def __init__(self, client: FleetClient, store: ProfileStore,
                 git_sha: str, chip: str) -> None:
        import uuid

        self.client = client
        self.store = store
        self.git_sha = git_sha
        self.chip = chip
        self.source = uuid.uuid4().hex  # identifies this run's push stream
        self._seq = 0
        self._lock = threading.Lock()
        self._baseline = ProfileStore.from_json(store.to_json())
        self._pending: Optional[tuple[ProfileStore, ProfileStore, int]] = None
        self.pushed_samples = 0

    def push(self, raise_on_error: bool = False) -> dict[str, Any]:
        with self._lock:
            if self._pending is None:
                snap = ProfileStore.from_json(self.store.to_json())
                delta = snap.delta_since(self._baseline)
                if len(delta) == 0:
                    return {"pushed": False, "samples": 0}
                n = sum(e.count for e in delta._entries.values())
                self._seq += 1
                self._pending = (delta, snap, n)
            delta, snap, n = self._pending
            try:
                res = self.client.push(delta, self.git_sha, self.chip,
                                       source=self.source, seq=self._seq)
            except FleetError as exc:
                # ambiguous: the delta may or may not have landed — keep it
                # pending and retry the SAME (delta, seq) so the fleet can
                # dedup instead of double-merging
                if raise_on_error:
                    raise
                return {"pushed": False, "samples": 0, "error": str(exc)}
            # acknowledged (merged now, or recognised as an earlier duplicate)
            self._baseline = snap
            self._pending = None
            self.pushed_samples += n
            return {"pushed": True, **res}


def warm_start_from_fleet(
    target: str, dispatcher: Any, token: Optional[str] = None
) -> tuple[dict[str, Any], FleetPusher]:
    """Driver-side fleet wiring (the ``--fleet`` flag on serve/train).

    Pulls the best matching snapshot (exact (git SHA, chip) → freshest
    same-chip → miss), Welford-merges it into the dispatcher's live store,
    ages out entries whose stamps mismatch this environment (a chip-only
    fallback across code versions degrades to cold re-exploration, never to
    trusting stale timings), and returns the driver-JSON record plus a
    :class:`FleetPusher` whose baseline excludes the pulled samples.  An
    unreachable fleet logs, starts cold, and still returns a pusher — pushes
    retry at each rotation.
    """
    import sys

    from repro_torch.trace.session import age_out_profiles, git_sha

    sha, chip_name = git_sha(), dispatcher.chip.name
    client = FleetClient(target, token=token)
    rec: dict[str, Any] = {"target": target}
    try:
        pulled = client.pull(sha, chip_name)
        pull_rec: dict[str, Any] = {"match": pulled["match"]}
        if pulled["store"] is not None:
            pull_rec["bucket_git_sha"] = pulled.get("git_sha")
            pull_rec["bucket_chip"] = pulled.get("chip")
            pull_rec["entries"] = len(pulled["store"])
            # discard stale-stamped fleet entries BEFORE merging: merging
            # first would degrade overlapping locally-valid entries (e.g.
            # from --profile-in) to 'mixed' and the age-out would then
            # destroy the driver's own warm-start data
            aged = pulled["store"].age_out(git_sha=sha, chip=chip_name)
            for a in aged:
                print(f"fleet: aged out {a['key']}: {a['reason']}",
                      file=sys.stderr)
            pull_rec["merged_samples"] = dispatcher.store.merge(pulled["store"])
            # unstamped fleet entries colliding with stamped local ones still
            # degrade to 'mixed' in the merge; evict those conservatively too
            pull_rec["aged_out"] = len(aged) + len(
                age_out_profiles(dispatcher.store, chip_name))
        rec["pull"] = pull_rec
        print(f"fleet: pull ({sha}, {chip_name}) -> {pull_rec['match']}"
              + (f", {pull_rec.get('entries')} entries"
                 f" ({pull_rec.get('aged_out')} aged out)"
                 if pulled["store"] is not None else ""),
              file=sys.stderr)
    except FleetError as exc:
        rec["pull"] = {"match": "error", "error": str(exc)}
        print(f"fleet: pull failed, starting cold: {exc}", file=sys.stderr)
    pusher = FleetPusher(client, dispatcher.store, sha, chip_name)
    return rec, pusher
