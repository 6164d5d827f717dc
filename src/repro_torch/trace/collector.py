"""Bounded trace collector: the perf-buffer front end of ``repro_torch.trace``
(counterpart of ``repro/trace/collector.py``).

A :class:`TraceCollector` IS an :class:`~repro_torch.core.events.EventLog` (it
subclasses it), so every component that takes ``log=`` — the serving engine,
the train supervisor, the dispatcher, uprobes, tracepoint callbacks — can
write into a bounded collector unchanged.  On top of the raw log it adds:

* **capacity + drop accounting** — bounded by default (``capacity`` events);
  ``stats()`` reports how many events the ring evicted, mirroring the
  perf-buffer "lost samples" counter the paper's pipeline watches;
* **tracks** — the per-unit views (step / microbatch / request / checkpoint /
  dispatch) a trace viewer renders as rows; event names map onto tracks via
  ``TRACK_OF`` (extensible per collector);
* **track-aware sampling** — tracks listed in ``track_capacity`` get their
  own dedicated rings, so a flood of hot request spans cannot evict the few
  tiny-but-precious dispatch or checkpoint events (one global ``maxlen``
  evicts exactly the wrong things under skewed load).  By default the
  ``dispatch`` and ``checkpoint`` tracks are reserved;
* **a device ring** — every ``device:*`` track (the kernels a live profiler
  window merges, :mod:`repro_torch.trace.liveprof`) shares one reserved ring
  of its own, ``"device"`` in ``track_capacity``: a compiled qwen2-0.5b
  decode tick runs ~1,590 kernels and a smollm-360m train step ~6,000, so
  one window over a few ticks would otherwise evict every request span
  from the main ring.  What that ring evicts is counted under ``"device"``;
* **streaming sinks** — ``set_sink(fn)`` invokes ``fn(event)`` on every
  *captured* record before any ring eviction, which is how a
  :class:`~repro_torch.trace.stream.StreamingSession` persists the full event
  stream even beyond ring capacity; ``add_sink(fn, sampled=False)`` fans in
  extra sinks that see **every** event including sampled-out ones (the
  metrics plane counts what the rings shed);
* **adaptive sampling gate** — ``set_sample_rate(r)`` duty-cycles span
  capture: non-essential events are admitted at rate ``r`` by an error
  accumulator, suppressed spawns remember their span id so the matching
  exit is suppressed too (pairing never tears), and dispatch / checkpoint /
  run / controller tracks are never shed.  Driven by
  :class:`repro_torch.metrics.controller.AdaptiveController`, which reads the
  record-path self-timing (records are wall-clocked end-to-end, every
  ``TIMING_EVERY``-th call) via ``timing_snapshot()``;
* **closed spans** — spawn/exit pairs resolved into ``Span`` records (by span
  id / payload identity, interleaving-safe) carrying parent links, the unit
  every exporter in :mod:`repro_torch.trace.export` consumes;
* **span trees** — :func:`span_tree` folds the parent links into a forest of
  :class:`SpanNode` (orphaned children — parent evicted from the ring — fall
  back to roots), the structure ``report --tree`` and the nested exporters
  render.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable, Mapping, Optional

from repro_torch.core.events import (Event, EventLog, _pair_key, current_span,
                               remote_ref)

DEFAULT_CAPACITY = 1 << 16  # 65536 events

# Canonical track per event name.  Anything unlisted lands on "other" unless
# the collector was constructed with extra mappings.
TRACK_OF: dict[str, str] = {
    "serve_run": "run",
    "train_run": "run",
    "router_run": "run",
    "replica": "router",
    "step": "step",
    "train_step": "step",
    "microbatch": "microbatch",
    "request": "request",
    "rpc": "request",
    "prefill": "request",
    "decode_tick": "request",
    "checkpoint": "checkpoint",
    "restart": "checkpoint",
    "elastic_resize": "checkpoint",
    "controller": "controller",
    "device_window": "controller",
}

# Host tracks order before device tracks (``device:<name>``, sorted after the
# canonical set) so viewers render host rows above their device rows.
TRACKS = ("run", "step", "microbatch", "request", "checkpoint", "dispatch",
          "router", "controller", "other")

# Tracks the sampling gate never sheds: rare, tiny, and load-bearing — the
# run envelope, dispatch/warm-start analysis, recovery lifecycle, and the
# controller's own decision trail.  Device tracks are also exempt (they are
# merged post-hoc and already rate-limited at their source).
ESSENTIAL_TRACKS = frozenset({"run", "dispatch", "checkpoint", "router",
                              "controller"})

# Every Nth record() is timed end-to-end (event build + ring + sinks).  The
# default times EVERY call: two perf_counter reads (~100 ns) against a
# multi-µs record path, and sparse sampling aliases badly with periodic
# in-sink costs — a streaming session fsyncing every 64 events lands the
# rotation on exactly the timed record when N is also 64, extrapolating one
# fsync to the whole stream.
TIMING_EVERY = 1


def default_track(e: Event) -> str:
    """Track of an event without a collector (module-level TRACK_OF only)."""
    if e.kind == "dispatch":
        return "dispatch"
    if e.kind == "route":
        return "router"
    if e.kind == "device":
        dev = e.payload.get("device") if isinstance(e.payload, dict) else None
        return f"device:{dev}" if dev else "device"
    return TRACK_OF.get(e.name, "other")

# Reserved per-track ring sizes: dispatch decisions and checkpoint lifecycle
# events are rare and small but drive warm-start + recovery analysis — they
# must survive a request-span flood that wraps the main ring many times over.
# The "device" ring holds every device:* track's events (see _ring_key).
DEFAULT_TRACK_CAPACITY: dict[str, int] = {
    "dispatch": 4096, "checkpoint": 1024, "router": 4096, "controller": 1024,
    "device": 1 << 17,
}


def _ring_key(track: str) -> str:
    """The reserved ring a track's events go to: one for all device tracks."""
    return "device" if track.startswith("device") else track


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed spawn/exit pair (or a zero-length instant for loose events).

    ``parent`` is the enclosing span's id (0 = root); ``truncated`` marks a
    span force-closed at the last observed event time because its exit was
    evicted from the ring (or the trace was cut while it was open).

    ``remote`` is the cross-process parent reference (the
    :meth:`repro_torch.core.events.SpanContext.to_payload` dict lifted from the
    spawn payload's ``"remote"`` key) — the parent span lives in *another*
    process's id space and is not required to exist locally.  ``parent``
    stays the local enclosing span so single-session trees render unchanged;
    :mod:`repro_torch.trace.stitch` re-points ``parent`` at the remote span once
    both sessions share one id space.
    """

    name: str
    track: str
    t0: float
    t1: float
    payload: Any = None
    span: int = 0
    parent: int = 0
    truncated: bool = False
    remote: Optional[dict] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class SpanNode:
    """One node of a span tree: a span plus its resolved children."""

    span: Span
    children: list["SpanNode"] = dataclasses.field(default_factory=list)

    @property
    def exclusive(self) -> float:
        """Self time: duration minus the children's (clamped at 0 — a child
        force-closed past its parent's exit can overshoot)."""
        return max(0.0, self.span.dur - sum(c.span.dur for c in self.children))


class TraceCollector(EventLog):
    """Bounded EventLog with track views, reserved rings and span resolution."""

    def __init__(
        self,
        capacity: int | None = DEFAULT_CAPACITY,
        *,
        track_of: Optional[Mapping[str, str]] = None,
        track_capacity: Optional[Mapping[str, int]] = None,
        sink: Optional[Callable[[Event], None]] = None,
    ) -> None:
        super().__init__(maxlen=capacity)
        self._track_of = dict(TRACK_OF)
        if track_of:
            self._track_of.update(track_of)
        caps = DEFAULT_TRACK_CAPACITY if track_capacity is None else dict(track_capacity)
        self._rings: dict[str, deque[Event]] = {
            t: deque(maxlen=n) for t, n in caps.items() if n
        }
        self._ring_dropped: dict[str, int] = {t: 0 for t in self._rings}
        self._sink = sink
        self._batch_sink: Optional[Callable[[list[Event]], None]] = None
        self._sink_error: Optional[str] = None
        self._extra_sinks: list[tuple[Callable[[Event], None], bool, bool]] = []
        # sampling gate state (all under self._lock)
        self._sample_rate = 1.0
        self._duty = 0.0
        self._suppressed: set[int] = set()
        self._sampled_out = 0
        # record-path self-timing (controller feedback signal)
        self._rec_count = 0
        self._rec_marked = 0
        self._timed_count = 0
        self._timed_total_s = 0.0

    # -- streaming sinks -----------------------------------------------------

    def set_sink(self, sink: Optional[Callable[[Event], None]],
                 batch: Optional[Callable[[list[Event]], None]] = None) -> None:
        """Install the primary per-event callback (``StreamingSession.emit``),
        and ``batch``, the same sink for a list of events
        (``StreamingSession.emit_many``), which :meth:`record_many` uses.

        The sink sees every *captured* event exactly once, before ring
        eviction, so a durable stream is a superset of the in-memory ring —
        provided the stream is closed only after all recording threads have
        quiesced (the sink runs outside the collector lock, so an in-flight
        record() racing ``StreamingSession.close()`` would be dropped by the
        sealed stream; every driver closes after its run loop has fully
        joined)."""
        self._sink = sink
        self._batch_sink = batch

    def add_sink(self, sink: Callable[[Event], None], *, sampled: bool = True,
                 timed: bool = True) -> None:
        """Fan in an additional sink.

        ``sampled=True`` sinks mirror the primary slot (captured events
        only); ``sampled=False`` sinks see every event including ones the
        sampling gate sheds — the metrics plane attaches this way so
        counters stay exact while capture is duty-cycled.  ``timed=False``
        sinks run after the record path's self-timing has stopped and after
        the primary sink: their work is charged elsewhere (a live
        profiler's window close, by its own budget), and what they record
        reaches the stream after the event that set them off."""
        self._extra_sinks.append((sink, sampled, timed))

    def remove_sink(self, sink: Callable[[Event], None]) -> None:
        self._extra_sinks = [x for x in self._extra_sinks if x[0] is not sink]

    # -- sampling gate -------------------------------------------------------

    @property
    def sample_rate(self) -> float:
        with self._lock:
            return self._sample_rate

    def set_sample_rate(self, rate: float) -> None:
        """Set the capture duty cycle in [0, 1]; 1.0 = capture everything."""
        with self._lock:
            self._sample_rate = min(1.0, max(0.0, float(rate)))

    # -- recording (track-aware) ---------------------------------------------

    def _track_for(self, kind: str, name: str, payload: Any = None) -> str:
        if kind == "dispatch":
            return "dispatch"
        if kind == "route":
            # routing decisions/outcomes mirror dispatch decisions one tier
            # up: rare, tiny, and load-bearing for accounting — own ring
            return "router"
        if kind == "device":
            dev = payload.get("device") if isinstance(payload, dict) else None
            return f"device:{dev}" if dev else "device"
        return self._track_of.get(name, "other")

    def _admit_locked(self, ev: Event, track: str) -> bool:
        """The sampling gate and the rings (under ``self._lock``): True if
        ``ev`` was captured."""
        kind, span = ev.kind, ev.span
        captured = True
        if kind == "exit" and span and span in self._suppressed:
            # spawn was shed: shed the exit too, whatever the gate says now
            self._suppressed.discard(span)
            self._sampled_out += 1
            captured = False
        elif (self._sample_rate < 1.0
              and track not in ESSENTIAL_TRACKS
              and not track.startswith("device")
              and not (kind == "exit" and span)):
            # exits of captured spans always pass (pairing never tears);
            # everything else goes through the duty-cycle accumulator
            self._duty += self._sample_rate
            if self._duty >= 1.0:
                self._duty -= 1.0
            else:
                self._sampled_out += 1
                captured = False
                if kind == "spawn" and span:
                    if len(self._suppressed) >= 65536:
                        self._suppressed.pop()
                    self._suppressed.add(span)
        if captured:
            ring_key = _ring_key(track)
            ring = self._rings.get(ring_key)
            if ring is not None:
                if ring.maxlen is not None and len(ring) == ring.maxlen:
                    self._ring_dropped[ring_key] += 1
                ring.append(ev)
            else:
                if self._events.maxlen is not None and len(self._events) == self._events.maxlen:
                    self._dropped += 1
                self._events.append(ev)
        return captured

    def _sink_failed(self, exc: Exception) -> None:
        self._sink_error = f"{type(exc).__name__}: {exc}"
        import sys

        print(f"trace sink detached after error: {self._sink_error}", file=sys.stderr)

    def _fan_out(self, ev: Event, captured: bool, timed: bool) -> None:
        """Hand ``ev`` to the extra sinks of one kind (outside the lock: sink
        I/O must not block writers); a sink that raises is detached."""
        for extra, wants_sampled, is_timed in list(self._extra_sinks):
            if is_timed != timed or (wants_sampled and not captured):
                continue
            try:
                extra(ev)
            except Exception as exc:
                self.remove_sink(extra)
                self._sink_failed(exc)

    def _to_primary(self, fn: Callable[[Any], None], arg: Any) -> None:
        try:
            fn(arg)
        except Exception as exc:
            # a broken sink (ENOSPC, closed file) must not take down the
            # traced run: detach it and surface the error via stats()
            self._sink = self._batch_sink = None
            self._sink_failed(exc)

    def record(
        self,
        kind: str,
        name: str,
        payload: Any = None,
        *,
        span: int = 0,
        parent: Optional[int] = None,
        t: Optional[float] = None,
    ) -> None:
        # racy read of _rec_count is fine: timing needs ~1/TIMING_EVERY calls
        t0 = (time.perf_counter()
              if TIMING_EVERY == 1 or self._rec_count % TIMING_EVERY == 0
              else None)
        if parent is None:
            parent = current_span()
        ev = Event(time.monotonic() if t is None else t, kind, name, payload,
                   span, parent)
        track = self._track_for(kind, name, payload)
        with self._lock:
            self._rec_count += 1
            captured = self._admit_locked(ev, track)
        self._fan_out(ev, captured, timed=True)
        sink = self._sink
        if captured and sink is not None:
            self._to_primary(sink, ev)
        if t0 is not None:
            dt = time.perf_counter() - t0
            with self._lock:
                self._timed_count += 1
                self._timed_total_s += dt
        self._fan_out(ev, captured, timed=False)

    def record_many(self, events: Iterable[Event]) -> None:
        """Record events built elsewhere (a live profiler's merged device
        slices) in one pass: through the gate and the rings as
        :meth:`record` would, outside the record path's self-timing (the
        profiler's budget charges the merge), to each extra sink, and to the
        primary sink in one call where it takes a batch (``set_sink``'s
        ``batch``): a window merges tens of thousands of events at once."""
        evs = list(events)
        with self._lock:
            admitted = [(ev, self._admit_locked(ev, self.track_name(ev))) for ev in evs]
        for ev, captured in admitted:
            self._fan_out(ev, captured, timed=True)
        kept = [ev for ev, captured in admitted if captured]
        if kept and self._batch_sink is not None:
            self._to_primary(self._batch_sink, kept)
        elif self._sink is not None:
            for ev in kept:
                self._to_primary(self._sink, ev)
        for ev, captured in admitted:
            self._fan_out(ev, captured, timed=False)

    def timing_snapshot(self) -> dict[str, Any]:
        """Read-and-reset the record-path self-timing accumulators.

        ``timed`` calls were wall-clocked end-to-end out of ``records`` total
        record() calls since the last snapshot — the adaptive controller
        multiplies the per-call cost back up by ``records`` to price the
        whole stream."""
        with self._lock:
            out = {
                "timed": self._timed_count,
                "timed_s": self._timed_total_s,
                "records": self._rec_count - self._rec_marked,
            }
            self._timed_count = 0
            self._timed_total_s = 0.0
            self._rec_marked = self._rec_count
        return out

    def events(self, kind: str | None = None, name: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._events)
            for ring in self._rings.values():
                evs.extend(ring)
        evs.sort(key=lambda e: e.t)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if name is not None:
            evs = [e for e in evs if e.name == name]
        return evs

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped + sum(self._ring_dropped.values())

    def dropped_by_track(self) -> dict[str, int]:
        """Per-reserved-track eviction counts (main-ring losses under ``""``),
        plus spans force-closed because their exit was evicted — an orphaned
        spawn is a lost measurement even though the spawn event itself
        survived, so it belongs in the same loss accounting.

        Spans legitimately still open count too (the resolver cannot tell an
        evicted exit from an in-flight unit): call at run end, after the
        root span has closed, for clean numbers — the drivers do."""
        with self._lock:
            out = dict(self._ring_dropped)
            out[""] = self._dropped
        orphans: dict[str, int] = {}
        resolve_spans(self.events(), self.track_name, orphans=orphans)
        for track, n in orphans.items():
            out[track] = out.get(track, 0) + n
        return out

    def drop_counters(self) -> dict[str, Any]:
        """Cheap loss counters (no span resolution): safe to poll mid-run.

        Unlike :meth:`dropped_by_track` this never walks the event stream,
        so the metrics plane and streaming-session manifests can refresh it
        on every scrape/rotation without perturbing the run."""
        with self._lock:
            by_track = {t: n for t, n in self._ring_dropped.items() if n}
            if self._dropped:
                by_track[""] = self._dropped
            return {
                "dropped": self._dropped + sum(self._ring_dropped.values()),
                "sampled_out": self._sampled_out,
                "by_track": by_track,
            }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            for ring in self._rings.values():
                ring.clear()
            self._ring_dropped = {t: 0 for t in self._rings}
            self._duty = 0.0
            self._suppressed.clear()
            self._sampled_out = 0

    def to_json(self) -> str:
        import json

        rows = [dataclasses.asdict(e) for e in self.events()]
        return json.dumps(
            {"dropped": self.dropped, "maxlen": self.maxlen, "events": rows},
            default=repr,
        )

    # -- track views ---------------------------------------------------------

    def track_name(self, event: Event) -> str:
        """The viewer row an event belongs to (dispatch/device are kind-keyed)."""
        return self._track_for(event.kind, event.name, event.payload)

    def track(self, track: str) -> list[Event]:
        return [e for e in self.events() if self.track_name(e) == track]

    def tracks(self) -> dict[str, list[Event]]:
        out: dict[str, list[Event]] = {t: [] for t in TRACKS}
        for e in self.events():
            out.setdefault(self.track_name(e), []).append(e)
        return {t: evs for t, evs in out.items() if evs}

    # -- span resolution -----------------------------------------------------

    def spans(self) -> list[Span]:
        return resolve_spans(self.events(), self.track_name)

    def span_tree(self) -> list["SpanNode"]:
        """The resolved spans folded into a parent-linked forest."""
        return span_tree(self.spans())

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        per_track = {t: len(evs) for t, evs in self.tracks().items()}
        with self._lock:
            track_capacity = {t: r.maxlen for t, r in self._rings.items()}
            sampled_out = self._sampled_out
            sample_rate = self._sample_rate
        return {
            "events": len(self),
            "capacity": self.maxlen,
            "dropped": self.dropped,
            "per_track": per_track,
            "track_capacity": track_capacity,
            "dropped_by_track": self.dropped_by_track(),
            "sampled_out": sampled_out,
            "sample_rate": sample_rate,
            "sink_error": self._sink_error,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._events) + sum(len(r) for r in self._rings.values())


def resolve_spans(
    events: Iterable[Event],
    track_name=None,
    *,
    orphans: Optional[dict[str, int]] = None,
) -> list[Span]:
    """Pair spawn/exit events into closed :class:`Span` records.

    Same pairing discipline as :meth:`EventLog.durations` — span id, then
    hashable payload, then LIFO fallback — applied across all names at once.
    Parent ids propagate from the spawn event onto the resolved span.

    A spawn whose exit never arrived (evicted from the ring, or the trace
    was cut while the unit was open) is **force-closed at the last observed
    event time** and marked ``truncated`` — silently dropping it would leak
    the whole unit from every report.  ``orphans``, when provided, collects
    per-track counts of those closes (folded into
    :meth:`TraceCollector.dropped_by_track`).

    Events of other kinds (mark/probe/straggler) become zero-length
    instants; ``dispatch`` events with a ``measured_s`` payload become spans
    covering their measured execution window, and ``device`` events with a
    ``dur_s`` payload become device-track spans (see
    :mod:`repro_torch.trace.device`).
    """
    if track_name is None:
        track_name = default_track
    out: list[Span] = []
    open_by_key: dict[Any, list[Event]] = {}
    stack_by_name: dict[str, list[Event]] = {}
    t_last = 0.0
    for e in events:
        t_last = max(t_last, e.t)
        if e.kind == "spawn":
            key = _pair_key(e)
            if key is not None:
                open_by_key.setdefault((e.name, key), []).append(e)
            else:
                stack_by_name.setdefault(e.name, []).append(e)
        elif e.kind == "exit":
            key = _pair_key(e)
            opened = open_by_key.get((e.name, key)) if key is not None else None
            if opened:
                s = opened.pop()
            elif key is None and stack_by_name.get(e.name):
                s = stack_by_name[e.name].pop()
            else:
                continue  # exit without a visible spawn (evicted from ring)
            out.append(Span(e.name, track_name(s), s.t, e.t, s.payload, s.span,
                            s.parent, remote=remote_ref(s.payload)))
        else:
            p = e.payload
            if e.kind == "dispatch" and isinstance(p, dict) and isinstance(
                p.get("measured_s"), (int, float)
            ):
                out.append(Span(e.name, track_name(e), e.t - p["measured_s"], e.t,
                                p, e.span, e.parent))
            elif e.kind == "device" and isinstance(p, dict) and isinstance(
                p.get("dur_s"), (int, float)
            ):
                out.append(Span(e.name, track_name(e), e.t, e.t + p["dur_s"],
                                p, e.span, e.parent))
            else:
                out.append(Span(e.name, track_name(e), e.t, e.t, p, e.span, e.parent))
    for opened in list(open_by_key.values()) + list(stack_by_name.values()):
        for s in opened:
            track = track_name(s)
            out.append(Span(s.name, track, s.t, t_last, s.payload, s.span,
                            s.parent, truncated=True, remote=remote_ref(s.payload)))
            if orphans is not None:
                orphans[track] = orphans.get(track, 0) + 1
    out.sort(key=lambda s: s.t0)
    return out


def span_tree(spans: Iterable[Span]) -> list[SpanNode]:
    """Fold parent links into a forest of :class:`SpanNode`.

    Orphan-to-root fallback: a span whose parent id is not among the
    resolved spans (the parent's events were evicted before the trace was
    read) becomes a root — the subtree survives instead of vanishing.  Span
    ids are allocated before their children's, so a parent id >= the span's
    own id is treated as corrupt and also falls back to root (keeps the
    forest acyclic on torn input).  Roots and children are ordered by start
    time.
    """
    nodes = [SpanNode(s) for s in spans]
    by_id: dict[int, SpanNode] = {}
    for n in nodes:
        if n.span.span:
            by_id.setdefault(n.span.span, n)
    roots: list[SpanNode] = []
    for n in nodes:
        p = n.span.parent
        parent = by_id.get(p) if p else None
        if parent is None or parent is n or (n.span.span and p >= n.span.span):
            roots.append(n)
        else:
            parent.children.append(n)
    for n in nodes:
        n.children.sort(key=lambda c: c.span.t0)
    roots.sort(key=lambda n: n.span.t0)
    return roots
