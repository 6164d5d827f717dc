"""Durable streaming trace sessions: JSONL segments + manifest + recovery
(counterpart of ``repro/trace/stream.py``; the same manifest and segment
layout, so a directory written by either package compacts in the other).

:class:`~repro_torch.trace.session.Session` snapshots a run *at the end*; a crash
loses the whole trace.  A :class:`StreamingSession` is the durable
counterpart: every event is appended to an open JSONL segment file as it is
recorded (attach it to a :class:`~repro_torch.trace.collector.TraceCollector` as a
sink), and segments rotate on a size/count budget.  Rotation is the
durability point — the closing segment is flushed **and fsynced** before it
is renamed from ``*.jsonl.open`` to ``*.jsonl``, the manifest is atomically
rewritten, and (when a profile provider is attached) the current
:class:`~repro_torch.dispatch.profiles.ProfileStore` is snapshotted next to it.
A SIGKILLed run therefore loses at most the tail of the one open segment.

On-disk layout of a session directory::

    MANIFEST.json          # schema + git/chip/argv provenance + segment index
    segment-000000.jsonl   # closed (fsynced) segments, one Event per line
    segment-000001.jsonl
    segment-000002.jsonl.open   # the open segment a crash may truncate
    profiles.json          # ProfileStore snapshot as of the last rotation

``python -m repro_torch.trace compact <dir> -o session.json`` folds the segments
back into the one-file session format; ``report``/``export``/``diff`` accept
segment directories directly (they compact in memory).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import threading
from typing import Any, Callable, Optional

from repro_torch.core.events import Event
from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.trace.session import SESSION_SCHEMA, Session, run_metadata
from repro_torch.utils.io import atomic_write as _atomic_write

STREAM_SCHEMA = "repro.trace.stream/v1"
MANIFEST_NAME = "MANIFEST.json"
PROFILES_NAME = "profiles.json"
METRICS_NAME = "metrics.jsonl"
SEGMENT_PREFIX = "segment-"
OPEN_SUFFIX = ".open"

DEFAULT_ROTATE_EVENTS = 2048
DEFAULT_ROTATE_BYTES = 4 << 20  # 4 MiB


class StreamingSession:
    """Appends events incrementally as rotated, fsynced JSONL segments.

    Thread-safe (events arrive from the checkpoint writer thread as well as
    the main loop).  Use as a sink on a collector::

        stream = StreamingSession("run_dir", rotate_events=2048)
        stream.attach(collector)          # every collector.record() streams
        ...
        stream.close(stats=collector.stats())

    ``store_provider`` (a zero-arg callable returning a ProfileStore) makes
    each rotation also persist the measured profiles, so a crashed run keeps
    its warm-start data up to the last closed segment.

    ``max_segments=N`` bounds the directory on long-lived servers: after each
    rotation the oldest closed segments beyond N are deleted (the manifest
    counts them in ``pruned_segments``/``pruned_events``; recovery tolerates
    the resulting gaps in segment numbering).

    ``fleet_push`` (a zero-arg callable, typically
    :meth:`repro_torch.fleet.client.FleetPusher.push`) is invoked best-effort at
    every rotation, so a long-lived server continuously feeds the central
    fleet profile store instead of only at shutdown.  Rotation-time pushes
    run on a background thread — a slow or unreachable fleet must not stall
    the traced (and locked) event path; a push still in flight makes the next
    rotation skip (deltas ride the following push).  ``close()`` pushes
    synchronously so shutdown never loses the final delta.
    """

    def __init__(
        self,
        path: str,
        *,
        rotate_events: int = DEFAULT_ROTATE_EVENTS,
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
        max_segments: Optional[int] = None,
        meta: Optional[dict[str, Any]] = None,
        chip: Optional[dict[str, Any]] = None,
        store_provider: Optional[Callable[[], ProfileStore]] = None,
        fleet_push: Optional[Callable[[], Any]] = None,
        metrics_provider: Optional[Callable[[], dict[str, Any]]] = None,
        stats_provider: Optional[Callable[[], dict[str, Any]]] = None,
        device_provider: Optional[Callable[[], dict[str, Any]]] = None,
    ) -> None:
        if rotate_events < 1:
            raise ValueError(f"rotate_events must be >= 1, got {rotate_events}")
        if max_segments is not None and max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        self.path = path
        self.rotate_events = rotate_events
        self.rotate_bytes = rotate_bytes
        self.max_segments = max_segments
        self.store_provider = store_provider
        self.fleet_push = fleet_push
        self.metrics_provider = metrics_provider
        self.stats_provider = stats_provider
        self.device_provider = device_provider
        if chip is None:
            from repro_torch.hw.specs import default_chip

            chip = dataclasses.asdict(default_chip())
        self._manifest: dict[str, Any] = {
            "schema": STREAM_SCHEMA,
            **run_metadata(meta),
            "chip": chip,
            "rotate_events": rotate_events,
            "rotate_bytes": rotate_bytes,
            "max_segments": max_segments,
            "segments": [],
            "pruned_segments": 0,
            "pruned_events": 0,
            "closed": False,
        }
        self._lock = threading.Lock()
        self._fleet_thread: Optional[threading.Thread] = None
        self._seg_index = 0
        self._seg_events = 0
        self._seg_bytes = 0
        self._seg_file: Optional[Any] = None
        self._total_events = 0
        self._closed = False
        os.makedirs(path, exist_ok=True)
        leftover = glob.glob(os.path.join(path, f"{SEGMENT_PREFIX}*.jsonl*"))
        if leftover or os.path.exists(os.path.join(path, MANIFEST_NAME)):
            # never overwrite or silently merge with a previous session — its
            # segments may be the only copy of a crashed run's trace
            raise FileExistsError(
                f"{path} already holds a streaming trace session; compact it "
                f"(`python -m repro_torch.trace compact {path}`) and remove the "
                "directory, or pass a fresh --trace-dir"
            )
        self._write_manifest()
        self._open_segment()

    # -- wiring ---------------------------------------------------------------

    def attach(self, collector: Any) -> "StreamingSession":
        """Register as the collector's event sink (returns self).

        Also adopts the collector's cheap loss counters
        (:meth:`~repro_torch.trace.collector.TraceCollector.drop_counters`) as the
        manifest's ``drops`` provider unless one was passed explicitly, so
        every rotation records up-to-date drop/shed totals for ``tail`` to
        warn on."""
        collector.set_sink(self.emit, self.emit_many)
        if self.stats_provider is None:
            self.stats_provider = getattr(collector, "drop_counters", None)
        return self

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- segment plumbing -----------------------------------------------------

    def _seg_name(self, index: int) -> str:
        return f"{SEGMENT_PREFIX}{index:06d}.jsonl"

    def _open_segment(self) -> None:
        self._seg_file = open(
            os.path.join(self.path, self._seg_name(self._seg_index) + OPEN_SUFFIX), "w"
        )
        self._seg_events = 0
        self._seg_bytes = 0

    def _write_manifest(self) -> None:
        _atomic_write(
            os.path.join(self.path, MANIFEST_NAME),
            json.dumps(self._manifest, indent=1, default=repr),
        )

    def set_meta(self, key: str, value: Any) -> None:
        """Set one manifest metadata key and rewrite the manifest now.

        For run-level facts learned after the session was opened — e.g. the
        router front door records each replica's trace directory under
        ``replica_sessions`` as replicas come up, so ``repro_torch.trace stitch``
        can discover the fleet's sessions from the frontdoor manifest alone.
        ``load_stream`` surfaces every such key in ``Session.meta``.
        """
        with self._lock:
            if self._closed:
                return
            self._manifest[key] = value
            self._write_manifest()

    def _close_segment_locked(self) -> None:
        """Flush + fsync + rename the open segment; record it in the manifest."""
        f = self._seg_file
        if f is None:
            return
        f.flush()
        os.fsync(f.fileno())
        f.close()
        self._seg_file = None
        name = self._seg_name(self._seg_index)
        os.replace(os.path.join(self.path, name + OPEN_SUFFIX),
                   os.path.join(self.path, name))
        self._manifest["segments"].append(
            {"name": name, "events": self._seg_events, "bytes": self._seg_bytes}
        )
        self._seg_index += 1
        self._prune_locked()
        self._snapshot_profiles_locked()
        self._snapshot_metrics_locked(segment=name)
        self._write_manifest()
        self._fleet_push_locked()

    def _prune_locked(self) -> None:
        """Segment retention: delete the oldest closed segments past
        ``max_segments`` so a long-lived server's --trace-dir stays bounded.
        The manifest records what was lost (count + events) and keeps only the
        surviving segments in its index — recovery tolerates the numbering gap."""
        if self.max_segments is None:
            return
        segments = self._manifest["segments"]
        while len(segments) > self.max_segments:
            victim = segments.pop(0)
            try:
                os.unlink(os.path.join(self.path, victim["name"]))
            except FileNotFoundError:
                pass
            self._manifest["pruned_segments"] += 1
            self._manifest["pruned_events"] += victim.get("events", 0)

    def _fleet_push_locked(self, sync: bool = False) -> None:
        """Feed the fleet profile store at each rotation (best effort): an
        unreachable fleet must not abort — or stall — the traced run, so
        rotation pushes run on a background thread (FleetPusher keeps its
        baseline on failure and is itself thread-safe, so a skipped or failed
        push just means those samples ride the next one).  ``sync=True``
        (close) joins any in-flight push and then pushes inline, so the final
        delta is durable before the process exits."""
        if self.fleet_push is None:
            return

        def run() -> None:
            try:
                self.fleet_push()
            except Exception as exc:
                import sys

                print(f"trace stream: fleet push failed ({type(exc).__name__}: "
                      f"{exc}); segments unaffected", file=sys.stderr)

        prev = self._fleet_thread
        if sync:
            # the push thread never takes the stream lock, so joining here
            # (under it) cannot deadlock
            if prev is not None and prev.is_alive():
                prev.join()
            run()
            return
        if prev is not None and prev.is_alive():
            return  # still pushing the previous delta; this one rides along
        self._fleet_thread = threading.Thread(
            target=run, name="trace-fleet-push", daemon=True)
        self._fleet_thread.start()

    def _snapshot_profiles_locked(self) -> None:
        """Persist the current ProfileStore next to the segments (best
        effort): a failed snapshot must not abort the event stream — the
        segments are the primary artifact, profiles are warm-start gravy."""
        if self.store_provider is None:
            return
        try:
            store = self.store_provider()
            if store is not None:
                _atomic_write(os.path.join(self.path, PROFILES_NAME), store.to_json())
                self._manifest["profiles"] = PROFILES_NAME
        except Exception as exc:
            import sys

            print(f"trace stream: profile snapshot failed ({type(exc).__name__}: "
                  f"{exc}); segments unaffected", file=sys.stderr)

    def _snapshot_metrics_locked(self, segment: Optional[str] = None) -> None:
        """Refresh the manifest's drop counters and append the current metric
        snapshot to ``metrics.jsonl`` (best effort, like profiles): one row
        per rotation gives ``repro_torch.trace metrics`` the run's metric timeline,
        and the manifest always carries the latest snapshot + loss totals."""
        import sys
        import time as _time

        if self.stats_provider is not None:
            try:
                drops = self.stats_provider()
                if drops is not None:
                    self._manifest["drops"] = drops
            except Exception as exc:
                print(f"trace stream: drop-counter refresh failed "
                      f"({type(exc).__name__}: {exc})", file=sys.stderr)
        if self.device_provider is not None:
            # per-window device-capture coverage rides in the manifest so a
            # crashed run still knows which windows made it to disk
            try:
                dev = self.device_provider()
                if dev is not None:
                    self._manifest["device_capture"] = dev
            except Exception as exc:
                print(f"trace stream: device-capture refresh failed "
                      f"({type(exc).__name__}: {exc})", file=sys.stderr)
        if self.metrics_provider is None:
            return
        try:
            snap = self.metrics_provider()
            if snap is None:
                return
            self._manifest["metrics"] = snap
            row = {"t": _time.time(), "segment": segment, "metrics": snap}
            with open(os.path.join(self.path, METRICS_NAME), "a") as f:
                f.write(json.dumps(row, default=repr) + "\n")
        except Exception as exc:
            print(f"trace stream: metrics snapshot failed ({type(exc).__name__}: "
                  f"{exc}); segments unaffected", file=sys.stderr)

    # -- the streaming path ---------------------------------------------------

    def emit(self, event: Event) -> None:
        """Append one event to the open segment (the collector-sink entry).
        The row is the event's fields in order, as ``dataclasses.asdict``
        gives them, without its deep copy of the payload (a live profiler
        window merges thousands of events at once)."""
        self.emit_many([event])

    def emit_many(self, events: list[Event]) -> None:
        """Append events to the open segment(s), rotating where one event at a
        time would, with one flush at the end (a live profiler's merge)."""
        lines = [json.dumps({"t": e.t, "kind": e.kind, "name": e.name, "payload": e.payload,
                             "span": e.span, "parent": e.parent}, default=repr) + "\n"
                 for e in events]
        with self._lock:
            if self._closed:
                return
            for line in lines:
                self._seg_file.write(line)
                self._seg_events += 1
                self._seg_bytes += len(line)
                self._total_events += 1
                if (self._seg_events >= self.rotate_events
                        or self._seg_bytes >= self.rotate_bytes):
                    self._close_segment_locked()
                    self._open_segment()
            self._seg_file.flush()  # crash-visible at once; fsync on rotate

    def rotate(self) -> None:
        """Force a rotation (e.g. aligned with a checkpoint): make the
        current segment durable even if it is under the rotation budget."""
        with self._lock:
            if self._closed or self._seg_events == 0:
                return
            self._close_segment_locked()
            self._open_segment()

    def close(self, stats: Optional[dict[str, Any]] = None) -> str:
        """Seal the session: final rotation + closed manifest.  Idempotent."""
        with self._lock:
            if self._closed:
                return self.path
            if self._seg_events > 0:
                self._close_segment_locked()
            elif self._seg_file is not None:
                # empty open segment: remove rather than leave a zero-byte file
                name = self._seg_name(self._seg_index) + OPEN_SUFFIX
                self._seg_file.close()
                self._seg_file = None
                os.unlink(os.path.join(self.path, name))
            # final profile + metric snapshots: anything since the last
            # rotation must survive the run (and reach the fleet)
            self._snapshot_profiles_locked()
            self._snapshot_metrics_locked(segment="final")
            self._fleet_push_locked(sync=True)
            self._manifest["closed"] = True
            self._manifest["total_events"] = self._total_events
            if stats is not None:
                self._manifest["collector"] = stats
            self._write_manifest()
            self._closed = True
        return self.path


# -- recovery / compaction ---------------------------------------------------


def is_stream_dir(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, MANIFEST_NAME))
        or bool(glob.glob(os.path.join(path, f"{SEGMENT_PREFIX}*.jsonl*")))
    )


def _read_segment(path: str, lenient: bool) -> tuple[list[Event], int]:
    """Parse one JSONL segment.  ``lenient`` tolerates a torn tail line
    (the open segment of a crashed run); closed segments are fsynced and a
    parse failure there is reported too rather than raising."""
    events: list[Event] = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                events.append(Event(**row))
            except (json.JSONDecodeError, TypeError):
                skipped += 1
                if not lenient:
                    raise
    return events, skipped


def load_stream(path: str) -> Session:
    """Recover a segment directory into a :class:`Session` (crash-safe).

    Reads the manifest for provenance, every closed ``segment-*.jsonl`` in
    order, and salvages complete lines from any ``*.open`` segment the crash
    left behind.  Dispatch decisions are rebuilt from the streamed
    ``dispatch`` events; profiles come from the last rotation's snapshot.
    """
    manifest: dict[str, Any] = {}
    mpath = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)

    closed = sorted(glob.glob(os.path.join(path, f"{SEGMENT_PREFIX}*.jsonl")))
    open_segs = sorted(glob.glob(os.path.join(path, f"{SEGMENT_PREFIX}*.jsonl{OPEN_SUFFIX}")))
    if not closed and not open_segs and not manifest:
        raise FileNotFoundError(f"{path} is not a streaming trace session "
                                f"(no {MANIFEST_NAME} or {SEGMENT_PREFIX}*.jsonl)")

    events: list[Event] = []
    skipped = 0
    for seg in closed:
        evs, bad = _read_segment(seg, lenient=True)
        events.extend(evs)
        skipped += bad
    salvaged = 0
    for seg in open_segs:
        evs, bad = _read_segment(seg, lenient=True)
        events.extend(evs)
        salvaged += len(evs)
        skipped += bad
    events.sort(key=lambda e: e.t)

    decisions = [e.payload for e in events
                 if e.kind == "dispatch" and isinstance(e.payload, dict)]
    store = None
    ppath = os.path.join(path, PROFILES_NAME)
    if os.path.exists(ppath):
        with open(ppath) as f:
            store = ProfileStore.from_json(f.read())

    meta = {k: v for k, v in manifest.items()
            if k not in ("schema", "segments", "chip", "closed")}
    meta["schema"] = SESSION_SCHEMA
    timeline = load_metrics_timeline(path)
    if timeline:
        meta["metrics_timeline"] = timeline
    meta["stream"] = {
        "dir": path,
        "schema": manifest.get("schema", STREAM_SCHEMA),
        "closed": manifest.get("closed", False),
        "segments": len(closed),
        "open_segments": len(open_segs),
        "salvaged_events": salvaged,
        "skipped_lines": skipped,
        "pruned_segments": manifest.get("pruned_segments", 0),
        "pruned_events": manifest.get("pruned_events", 0),
    }
    collector_stats = manifest.get("collector") or {}
    return Session(
        meta=meta,
        events=events,
        dropped=collector_stats.get("dropped", 0),
        capacity=collector_stats.get("capacity"),
        decisions=decisions,
        store=store,
        chip=manifest.get("chip"),
        collector_stats=collector_stats or None,
    )


def load_metrics_timeline(path: str) -> list[dict[str, Any]]:
    """Parse a session directory's per-rotation ``metrics.jsonl`` rows
    (lenient: a torn tail line from a crash is skipped, not fatal)."""
    mx = os.path.join(path, METRICS_NAME)
    rows: list[dict[str, Any]] = []
    if not os.path.exists(mx):
        return rows
    with open(mx) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def load_any(path: str) -> Session:
    """Load a one-file session OR a streaming segment directory."""
    if os.path.isdir(path):
        return load_stream(path)
    return Session.load(path)


# -- live tailing -------------------------------------------------------------


def _seg_indices(path: str) -> list[int]:
    out = set()
    for p in glob.glob(os.path.join(path, f"{SEGMENT_PREFIX}*.jsonl*")):
        digits = os.path.basename(p)[len(SEGMENT_PREFIX):].split(".", 1)[0]
        if digits.isdigit():
            out.add(int(digits))
    return sorted(out)


def _render_event(row: dict[str, Any], open_spans: dict[Any, Any]) -> str:
    """One human line per event: track, kind, depth-marked name, duration.

    ``open_spans`` maps span keys to ``(t0, depth)``; depth comes from the
    event's ``parent`` link when that parent is still open, so nested units
    (request > prefill > dispatch) indent under their ancestors live.
    """
    from repro_torch.trace.collector import TRACK_OF

    t = row.get("t", 0.0)
    kind = str(row.get("kind", "?"))
    name = str(row.get("name", "?"))
    payload = row.get("payload")
    if kind == "dispatch":
        track = "dispatch"
    elif kind == "device":
        dev = payload.get("device") if isinstance(payload, dict) else None
        track = f"device:{dev}" if dev else "device"
    else:
        track = TRACK_OF.get(name, "other")
    key = ("span", row["span"]) if row.get("span") else ("name", name)
    parent = row.get("parent") or 0
    pent = open_spans.get(("span", parent)) if parent else None
    depth = (pent[1] + 1) if pent is not None else 0
    extra = ""
    if kind == "spawn":
        open_spans[key] = (t, depth)
    elif kind == "exit":
        ent = open_spans.pop(key, None)
        if ent is not None:
            extra = f"dur={1e3 * (t - ent[0]):.3f}ms"
            depth = ent[1]
    elif kind == "dispatch" and isinstance(payload, dict):
        extra = f"{payload.get('backend')} ({payload.get('source')})"
        if isinstance(payload.get("measured_s"), (int, float)):
            extra += f" dur={1e3 * payload['measured_s']:.3f}ms"
    elif kind == "device" and isinstance(payload, dict) and isinstance(
        payload.get("dur_s"), (int, float)
    ):
        extra = f"dur={1e3 * payload['dur_s']:.3f}ms"
    marked = "· " * depth + name  # depth markers: one dot per ancestor level
    return f"{t:14.6f}  {track:<10} {kind:<8} {marked:<18} {extra}".rstrip()


class _Tailer:
    """Incremental reader over a live segment directory.

    Tracks (segment index, byte offset); a segment is drained from its
    ``.open`` file and finished when its closed (renamed) form exists — the
    rename preserves content, so the offset carries over.  Pruned/missing
    indices are skipped (retention deletes the oldest closed segments)."""

    def __init__(self, path: str) -> None:
        self.path = path
        indices = _seg_indices(path)
        self.index = indices[0] if indices else 0
        self.offset = 0
        self.open_spans: dict[Any, tuple[float, int]] = {}
        self.last_dropped = 0
        self.last_sampled_out = 0

    def _paths(self, index: int) -> tuple[str, str]:
        name = os.path.join(self.path, f"{SEGMENT_PREFIX}{index:06d}.jsonl")
        return name, name + OPEN_SUFFIX

    def poll(self) -> list[str]:
        """Render every complete line that appeared since the last poll."""
        out: list[str] = []
        while True:
            closed, open_ = self._paths(self.index)
            is_closed = os.path.exists(closed)
            target = closed if is_closed else open_
            if not os.path.exists(target):
                indices = _seg_indices(self.path)
                if self.index in indices:
                    # raced a rotation rename between the closed/open exists
                    # checks: the segment is still there, just under its
                    # other name — re-evaluate, this is not a gap
                    continue
                later = [i for i in indices if i > self.index]
                if later:  # pruned or skipped index: jump the gap, visibly —
                    # a silent skip would read as "those events never happened"
                    out.append(
                        f"# gap: segments {self.index:06d}..{later[0] - 1:06d} "
                        "pruned by retention"
                        + (" (partially shown)" if self.offset else "")
                    )
                    self.index, self.offset = later[0], 0
                    continue
                return out
            try:
                with open(target) as f:
                    f.seek(self.offset)
                    chunk = f.read()
            except FileNotFoundError:
                # raced a rotation rename (or retention unlink) between the
                # exists() check and the open: re-evaluate from the top
                continue
            # only complete lines; a torn tail stays buffered in the file
            end = chunk.rfind("\n") + 1
            for line in chunk[:end].splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn line mid-segment (crash remnant)
                out.append(_render_event(row, self.open_spans))
            self.offset += end
            if is_closed:  # fully drained and sealed: move on
                self.index += 1
                self.offset = 0
            else:
                return out

    def stream_closed(self) -> bool:
        try:
            with open(os.path.join(self.path, MANIFEST_NAME)) as f:
                return bool(json.load(f).get("closed"))
        except (FileNotFoundError, json.JSONDecodeError):
            return False

    def drop_warning(self) -> Optional[str]:
        """One-line warning when the manifest's loss counters grew since the
        previous check (rotations refresh them): drops mean the stream is
        complete but the in-memory rings are lossy — the reader should know
        before trusting ring-derived reports."""
        try:
            with open(os.path.join(self.path, MANIFEST_NAME)) as f:
                drops = json.load(f).get("drops") or {}
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        dropped = int(drops.get("dropped") or 0)
        sampled = int(drops.get("sampled_out") or 0)
        if dropped <= self.last_dropped and sampled <= self.last_sampled_out:
            return None
        parts = []
        if dropped > self.last_dropped:
            by = {k or "main": v for k, v in (drops.get("by_track") or {}).items() if v}
            parts.append(f"{dropped} events dropped by bounded rings "
                         f"(+{dropped - self.last_dropped}) by_track={by}")
        if sampled > self.last_sampled_out:
            parts.append(f"{sampled} events shed by adaptive sampling "
                         f"(+{sampled - self.last_sampled_out})")
        self.last_dropped, self.last_sampled_out = dropped, sampled
        return "# WARNING: " + "; ".join(parts)


def tail_stream(path: str, *, once: bool = False, poll_s: float = 0.2,
                out: Any = None) -> int:
    """Follow a ``--trace-dir`` like ``tail -f`` (one rendered line/event).

    Re-stats on rotation (the open segment's rename to its closed form is
    detected and the offset carried over), skips pruned segment indices, and
    returns once the manifest reports the session closed and every line has
    been printed.  ``once=True`` drains what exists now and returns (tests,
    scripting).  Ctrl-C returns 0.
    """
    import sys
    import time as _time

    out = sys.stdout if out is None else out
    if not is_stream_dir(path):
        raise FileNotFoundError(f"{path} is not a streaming trace session")
    tailer = _Tailer(path)
    try:
        while True:
            for line in tailer.poll():
                print(line, file=out)
            warning = tailer.drop_warning()
            if warning:
                print(warning, file=out)
            out.flush()
            if once or tailer.stream_closed():
                # one final drain: lines written between poll and the closed
                # manifest must not be lost
                for line in tailer.poll():
                    print(line, file=out)
                warning = tailer.drop_warning()
                if warning:
                    print(warning, file=out)
                out.flush()
                return 0
            _time.sleep(poll_s)
    except KeyboardInterrupt:
        return 0
