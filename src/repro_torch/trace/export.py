"""Trace exporters: Chrome Trace Event JSON, speedscope, folded stacks
(counterpart of ``repro/trace/export.py``: for the same events the output
is the JAX package's, byte for byte).

Everything a standard viewer can open:

* :func:`to_chrome_trace` — the Trace Event Format (``traceEvents``) that
  Perfetto / ``chrome://tracing`` load directly.  Spawn/exit pairs become
  async ``b``/``e`` duration events **grouped by their root span id**, so a
  request and every descendant (prefill, nested lifecycles) nest on one
  async track exactly like the span tree; dispatch decisions become ``X``
  complete events spanning their measured execution with ``s``/``f`` flow
  links from the request span that caused them; device events (merged via
  :mod:`repro_torch.trace.device`) become ``X`` rows on per-device tracks below
  the host tracks; loose marks/probes become ``i`` instants.
* :func:`to_speedscope` — an **evented** speedscope profile per track
  (open/close events follow the span tree, rebalanced where siblings
  overlap so the file always validates), https://speedscope.app loads it.
* :func:`to_folded` — ``track;name count`` folded stacks for classic
  ``flamegraph.pl`` / inferno tooling (counts in integer microseconds).
"""
from __future__ import annotations

import json
from typing import Any, Iterable, Optional

from repro_torch.core.events import Event
from repro_torch.trace.collector import (
    TRACKS,
    Span,
    TraceCollector,
    default_track,
    resolve_spans,
    span_tree,
)

PID = 1  # single-process traces; tracks are threads


def _track_ids(tracks: Iterable[str]) -> dict[str, int]:
    order = {t: i for i, t in enumerate(TRACKS)}
    # canonical tracks keep stable tids; custom tracks (including device:*)
    # get distinct tids after them (alphabetical), one viewer row each —
    # host rows therefore always render above device rows
    uniq = sorted(set(tracks), key=lambda t: (order.get(t, len(order)), t))
    return {t: i + 1 for i, t in enumerate(uniq)}


def _payload_args(payload: Any) -> dict[str, Any]:
    if isinstance(payload, dict):
        return {k: v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
                for k, v in payload.items()}
    if payload is None:
        return {}
    return {"payload": payload if isinstance(payload, (int, float, str, bool)) else repr(payload)}


def _tracker(collector: Optional[TraceCollector]):
    return collector.track_name if collector is not None else default_track


def _parent_index(events: Iterable[Event]) -> dict[int, int]:
    """span id -> parent id, from every event that carries both."""
    out: dict[int, int] = {}
    for e in events:
        if e.span and e.parent:
            out.setdefault(e.span, e.parent)
    return out


def _root_of(span: int, parents: dict[int, int]) -> int:
    """Topmost ancestor of ``span`` (cycle-guarded: parents precede children)."""
    seen = set()
    while span in parents and span not in seen:
        seen.add(span)
        span = parents[span]
    return span


def to_chrome_trace(
    events: Iterable[Event],
    *,
    collector: Optional[TraceCollector] = None,
    meta: Optional[dict[str, Any]] = None,
) -> dict[str, Any]:
    """Trace Event Format dict: ``{"traceEvents": [...], "otherData": ...}``.

    Timestamps are microseconds relative to the first event (Perfetto is
    happiest with small positive ``ts``).

    Stitched sessions (``meta["stitch"]``, see :mod:`repro_torch.trace.stitch`)
    render **multi-process**: each input session's span-id range maps to its
    own Perfetto pid named by the process origin, and every re-linked
    cross-process parent link (a replica rpc span under a frontdoor route
    span) gets an ``s``/``f`` flow arrow crossing the two processes.
    Sessions without stitch metadata render exactly as before (one pid).
    """
    events = sorted(events, key=lambda e: e.t)
    track_name = _tracker(collector)
    tids = _track_ids(track_name(e) for e in events)
    parents = _parent_index(events)
    spawn_of = {e.span: e for e in events if e.kind == "spawn" and e.span}
    # any span-carrying, non-exit event (route instants included): flow-arrow
    # sources for cross-process parent links
    span_event_of: dict[int, Event] = {}
    for e in events:
        if e.span and e.kind != "exit":
            span_event_of.setdefault(e.span, e)

    # (lo, hi, pid, origin) per stitched input session, from the provenance
    # manifest's namespaced span-id ranges
    procs: list[tuple[int, int, int, str]] = []
    for i, inp in enumerate(((meta or {}).get("stitch") or {}).get("inputs", [])):
        ids = inp.get("span_ids") or [0, -1]
        procs.append((int(ids[0]), int(ids[1]), i + 1,
                      str(inp.get("origin") or f"proc{i}")))

    def pid_of_id(sid: int) -> int:
        for lo, hi, pid, _ in procs:
            if lo <= sid <= hi:
                return pid
        return PID

    def pid_of(e: Event) -> int:
        if not procs:
            return PID
        sid = e.span or e.parent
        return pid_of_id(sid) if sid else procs[0][2]

    def start_of(e: Event) -> float:
        # dispatch events are recorded at completion; their X row starts
        # measured_s earlier, and the epoch must cover that
        if e.kind == "dispatch" and isinstance(e.payload, dict) and isinstance(
            e.payload.get("measured_s"), (int, float)
        ):
            return e.t - e.payload["measured_s"]
        return e.t

    def proc_root_of(span: int) -> int:
        """Topmost ancestor of ``span`` *within its own process* — async
        grouping must not follow a re-linked parent into another pid
        (Perfetto scopes async ids per pid)."""
        seen = set()
        while span in parents and span not in seen:
            p = parents[span]
            if procs and pid_of_id(p) != pid_of_id(span):
                break
            seen.add(span)
            span = p
        return span

    def async_id(e: Event) -> Optional[str]:
        """Async grouping id for spawn/exit.  Parent-linked spans share their
        ROOT span's id, so Perfetto nests the whole subtree by timestamp on
        one async track — real parent nesting, not per-tid LIFO guessing.
        Unlinked spans fall back to their own id / payload identity."""
        if e.span:
            return str(proc_root_of(e.span))
        try:
            hash(e.payload)
        except TypeError:
            return None
        if e.payload is None:
            return None
        return f"{e.name}:{e.payload!r}"

    def flow_source(e: Event) -> Optional[Event]:
        """The spawn event a dispatch decision's flow arrow starts from: the
        nearest ancestor on the ``request`` track (the paper's unit of
        concurrency), else the direct parent span."""
        sid, fallback = e.parent, None
        while sid:
            src = spawn_of.get(sid)
            if src is None:
                break
            if fallback is None:
                fallback = src
            if track_name(src) == "request":
                return src
            sid = parents.get(sid, 0)
        return fallback

    t0 = min((start_of(e) for e in events), default=0.0)
    us = lambda t: round((t - t0) * 1e6, 3)  # noqa: E731

    rows: list[dict[str, Any]] = []
    if procs:
        for _, _, pid, origin in procs:
            rows.append({"ph": "M", "pid": pid, "name": "process_name",
                         "args": {"name": origin}})
        for pid, track in sorted({(pid_of(e), track_name(e)) for e in events}):
            rows.append({"ph": "M", "pid": pid, "tid": tids[track],
                         "name": "thread_name", "args": {"name": track}})
    else:
        rows.append({"ph": "M", "pid": PID, "name": "process_name",
                     "args": {"name": "repro"}})
        for track, tid in tids.items():
            rows.append({"ph": "M", "pid": PID, "tid": tid, "name": "thread_name",
                         "args": {"name": track}})
    n_flows = 0
    for e in events:
        tid = tids[track_name(e)]
        pid = pid_of(e)
        base = {"name": e.name, "pid": pid, "tid": tid, "ts": us(e.t),
                "args": _payload_args(e.payload)}
        if e.span:
            base["args"]["span"] = e.span
        if e.parent:
            base["args"]["parent"] = e.parent
        if e.kind in ("spawn", "exit"):
            # async b/e (grouped by root span id -> nested subtree) when the
            # event carries an identity; sync B/E (viewer LIFO) only for
            # legacy identity-less events
            aid = async_id(e)
            ph = {"spawn": ("b" if aid else "B"), "exit": ("e" if aid else "E")}[e.kind]
            row = {**base, "ph": ph, "cat": "lifecycle"}
            if aid:
                row["id"] = aid
            rows.append(row)
            if e.kind == "spawn" and procs and e.parent:
                # re-linked remote parent: draw the hop crossing processes
                src = span_event_of.get(e.parent)
                if src is not None and pid_of(src) != pid:
                    n_flows += 1
                    fid = str(n_flows)
                    rows.append({"ph": "s", "cat": "flow", "name": "rpc",
                                 "id": fid, "pid": pid_of(src),
                                 "tid": tids[track_name(src)], "ts": us(src.t)})
                    rows.append({"ph": "f", "bp": "e", "cat": "flow",
                                 "name": "rpc", "id": fid, "pid": pid,
                                 "tid": tid, "ts": us(e.t)})
        elif e.kind == "dispatch" and isinstance(e.payload, dict) and isinstance(
            e.payload.get("measured_s"), (int, float)
        ):
            dur = round(e.payload["measured_s"] * 1e6, 3)
            rows.append({**base, "ph": "X", "cat": "dispatch",
                         "ts": us(start_of(e)), "dur": dur})
            src = flow_source(e)
            if src is not None:
                # flow arrow: the request/step span that caused this dispatch
                n_flows += 1
                fid = str(n_flows)
                rows.append({"ph": "s", "cat": "flow", "name": "dispatch",
                             "id": fid, "pid": pid_of(src),
                             "tid": tids[track_name(src)], "ts": us(src.t)})
                rows.append({"ph": "f", "bp": "e", "cat": "flow", "name": "dispatch",
                             "id": fid, "pid": pid, "tid": tid,
                             "ts": us(start_of(e))})
        elif e.kind == "device" and isinstance(e.payload, dict) and isinstance(
            e.payload.get("dur_s"), (int, float)
        ):
            rows.append({**base, "ph": "X", "cat": "device",
                         "dur": round(e.payload["dur_s"] * 1e6, 3)})
        else:
            rows.append({**base, "ph": "i", "cat": e.kind, "s": "t"})
    out: dict[str, Any] = {"traceEvents": rows, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = _payload_args(meta)
    return out


def _evented_profile(track: str, spans: list[Span], epoch: float, frame) -> dict[str, Any]:
    """One speedscope ``evented`` profile for a track's spans.

    ``frame`` interns a span name into the shared frame table.  Open/close
    events are emitted in timestamp order with stack discipline enforced:
    when a span closes while a later-opened sibling is still on the stack
    (concurrent requests interleave on one track), the intervening frames
    are closed and immediately reopened — the rebalancing every chrome-trace
    importer applies, preserving per-frame weight while keeping the file
    valid.
    """
    # (t, kind, idx): closes sort before opens at the same instant so a
    # zero-gap back-to-back pair doesn't nest; ties between closes resolve
    # by reverse open order via the stack rebalancing below
    marks: list[tuple[float, int, int]] = []
    for i, s in enumerate(spans):
        marks.append((s.t0, 1, i))
        marks.append((s.t1, 0, i))
    marks.sort(key=lambda m: (m[0], m[1]))
    events: list[dict[str, Any]] = []
    stack: list[int] = []

    def emit(typ: str, idx: int, t: float) -> None:
        events.append({"type": typ, "frame": frame(spans[idx].name), "at": t - epoch})

    for t, kind, idx in marks:
        if kind == 1:
            stack.append(idx)
            emit("O", idx, t)
        else:
            if idx not in stack:
                continue
            reopen: list[int] = []
            while stack and stack[-1] != idx:
                top = stack.pop()
                emit("C", top, t)
                reopen.append(top)
            stack.pop()
            emit("C", idx, t)
            for top in reversed(reopen):
                stack.append(top)
                emit("O", top, t)
    end = max((s.t1 for s in spans), default=epoch)
    while stack:  # defensive: truncated spans are pre-closed by resolve_spans
        emit("C", stack.pop(), end)
    return {
        "type": "evented",
        "name": track,
        "unit": "seconds",
        "startValue": min((s.t0 for s in spans), default=epoch) - epoch,
        "endValue": end - epoch,
        "events": events,
    }


def to_speedscope(
    events: Iterable[Event],
    *,
    collector: Optional[TraceCollector] = None,
    name: str = "repro.trace",
    meta: Optional[dict[str, Any]] = None,
) -> dict[str, Any]:
    """Speedscope file: one **evented** profile per track.

    Each track's spans become open/close frame events whose nesting follows
    the span tree (a request frame encloses its prefill frame, which
    encloses nothing a sibling owns), instead of the flat one-weighted-
    sample-per-span profiles the exporter used to emit.  ``meta`` (session
    provenance) titles the profile with the run's git SHA so stacked
    speedscope tabs from different runs stay distinguishable.
    """
    if meta and meta.get("git_sha") and name == "repro.trace":
        name = f"repro.trace@{meta['git_sha']}"
    spans = resolve_spans(sorted(events, key=lambda e: e.t), _tracker(collector))
    frames: list[dict[str, str]] = []
    frame_idx: dict[str, int] = {}

    def frame(n: str) -> int:
        if n not in frame_idx:
            frame_idx[n] = len(frames)
            frames.append({"name": n})
        return frame_idx[n]

    by_track: dict[str, list[Span]] = {}
    for s in spans:
        if s.dur > 0:
            by_track.setdefault(s.track, []).append(s)
    epoch = min((s.t0 for ss in by_track.values() for s in ss), default=0.0)
    profiles = [
        _evented_profile(track, ss, epoch, frame)
        for track, ss in sorted(by_track.items())
    ]
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "shared": {"frames": frames},
        "profiles": profiles,
        "activeProfileIndex": 0,
        "exporter": "repro.trace",
    }


def to_folded(
    events: Iterable[Event],
    *,
    collector: Optional[TraceCollector] = None,
    meta: Optional[dict[str, Any]] = None,  # accepted for exporter uniformity
) -> str:
    """Folded flamegraph stacks: full ancestor paths, one line per leaf.

    Parent links turn the old flat ``track;name`` pairs into real stacks —
    ``request;prefill;serve_prefill`` style — weighted by each node's
    exclusive time so the flamegraph's column widths sum correctly.
    """
    spans = resolve_spans(sorted(events, key=lambda e: e.t), _tracker(collector))
    agg: dict[str, int] = {}

    def leaf_name(s: Span) -> str:
        n = s.name
        if isinstance(s.payload, dict) and "backend" in s.payload:
            n += f";{s.payload['backend']}"
        return n

    def walk(node, prefix: str) -> None:
        s = node.span
        stack = f"{prefix};{leaf_name(s)}" if prefix else f"{s.track};{leaf_name(s)}"
        us = int(round(node.exclusive * 1e6))
        if s.dur > 0 and us > 0:
            agg[stack] = agg.get(stack, 0) + us
        for c in node.children:
            walk(c, stack)

    for root in span_tree(spans):
        walk(root, "")
    return "\n".join(f"{k} {v}" for k, v in sorted(agg.items())) + ("\n" if agg else "")


FORMATS = {
    "chrome": lambda evs, **kw: json.dumps(to_chrome_trace(evs, **kw), indent=1),
    "speedscope": lambda evs, **kw: json.dumps(to_speedscope(evs, **kw), indent=1),
    "folded": lambda evs, **kw: to_folded(evs, **kw),
}


def export(events: Iterable[Event], fmt: str, **kw: Any) -> str:
    """Render ``events`` in ``fmt`` (one of {chrome, speedscope, folded})."""
    try:
        render = FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown format {fmt!r}; choose from {sorted(FORMATS)}") from None
    return render(events, **kw)
