"""Cross-process session stitching: one timeline for the whole fleet
(counterpart of ``repro/trace/stitch.py``; it reads sessions and segment
directories written by either package).

Since the router split serving into a frontdoor process plus N replica
processes, a request's trace is sharded: the frontdoor session holds the
``request``/``route``/``outcome`` spans, each replica session holds the
``rpc → request → prefill → dispatch`` subtree that actually served it, and
the only link between them is the :class:`repro_torch.core.events.SpanContext`
the frontdoor injected over HTTP.  ``stitch()`` merges those sessions into
one — Adaptyst's cross-process ambition (profile a *program*, not a
process) applied to this framework's span trees.  Three transformations:

* **Span-id namespacing** — span ids are process-unique, so two sessions
  collide.  Each input's ids are shifted by a per-session offset strictly
  above every id seen so far (the same allocate-above-the-max trick
  :mod:`repro_torch.trace.device` uses for device slices), preserving intra-
  session ordering — ``span_tree``'s parent-id < child-id sanity check
  keeps holding.
* **Clock alignment** — event timestamps are ``time.monotonic()`` with a
  per-process epoch.  Every session records a clock anchor (paired
  monotonic/wall samples, see :func:`repro_torch.trace.session.run_metadata`)
  mapping its events onto its own wall clock; residual *cross-host* skew is
  then estimated NTP-style from the request handshake pairs the frontdoor
  recorded (its send/recv wall stamps vs. the replica's recv/send stamps):
  ``theta = ((t1 - t0) + (t2 - t3)) / 2`` per pair, median over all pairs
  per origin.  The merged timeline is the frontdoor's wall clock.
* **Remote re-linking** — a replica ``rpc`` span carries its frontdoor
  route span as a ``remote`` payload ref (origin + span id in the origin's
  id space).  Once both sessions share one id space, the rpc's ``parent``
  is re-pointed at the mapped route span, so every consumer — ``report
  --tree``, the Perfetto/speedscope/flamegraph exporters, ``diff
  --by-path`` — sees replica subtrees under their owning frontdoor request
  with no code changes.

Provenance: the stitched session's ``meta["stitch"]`` records every input
(path, origin, event count, id offset + resulting span-id range, clock
offset, estimated skew, torn-span count) plus re-link totals, and is what
:func:`repro_torch.trace.export.to_chrome_trace` uses to split the merged trace
back into per-process Perfetto tracks with cross-process flow arrows.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import statistics
from typing import Any, Iterable, Optional

from repro_torch.core.events import Event, _pair_key, remote_ref
from repro_torch.trace.collector import Span, resolve_spans
from repro_torch.trace.session import Session

HOPS = ("frontdoor_queue", "network", "replica_queue", "service")


# -- input discovery ----------------------------------------------------------


def discover_inputs(frontdoor_path: str) -> list[str]:
    """Replica session dirs belonging to a frontdoor session.

    Primary source: the ``replica_sessions`` manifest key the router CLI
    maintains as replicas announce their trace dirs.  Fallback (manifest
    torn, or the router died before any replica came up): every streaming
    dir under ``<frontdoor-dir>/replicas/*/`` — the layout the router CLI
    creates.  Missing dirs are silently skipped (a replica may have been
    SIGKILLed before writing anything).
    """
    from repro_torch.trace.stream import is_stream_dir, load_any

    out: list[str] = []
    try:
        meta = load_any(frontdoor_path).meta
    except Exception:
        meta = {}
    for rec in meta.get("replica_sessions") or []:
        td = rec.get("trace_dir") if isinstance(rec, dict) else None
        if td and os.path.isdir(td) and td not in out:
            out.append(td)
    if not out and os.path.isdir(frontdoor_path):
        for d in sorted(glob.glob(os.path.join(frontdoor_path, "replicas", "*"))):
            if is_stream_dir(d) and d not in out:
                out.append(d)
    return out


# -- clock alignment ----------------------------------------------------------


def _clock_offset(sess: Session) -> float:
    """Offset mapping this session's monotonic timestamps to its wall clock.

    From the recorded anchor when present; for pre-anchor sessions, fall
    back to assuming the first event landed at ``created_unix``.
    """
    clock = sess.meta.get("clock")
    if isinstance(clock, dict):
        try:
            return float(clock["unix"]) - float(clock["monotonic"])
        except (KeyError, TypeError, ValueError):
            pass
    created = sess.meta.get("created_unix")
    if isinstance(created, (int, float)) and sess.events:
        return float(created) - min(e.t for e in sess.events)
    return 0.0


def _handshake_skews(ref: Session) -> dict[str, list[float]]:
    """Per-origin NTP-style skew samples from the reference session's
    ``outcome`` events (``theta`` = origin wall clock minus reference wall
    clock; positive = the origin's clock runs ahead)."""
    out: dict[str, list[float]] = {}
    for e in ref.events:
        p = e.payload
        if e.kind != "route" or not isinstance(p, dict):
            continue
        hs = p.get("hs")
        if not isinstance(hs, dict):
            continue
        try:
            t0 = float(hs["sent_unix"])
            t1 = float(hs["replica_recv_unix"])
            t2 = float(hs["replica_sent_unix"])
            t3 = float(hs["recv_unix"])
            origin = str(hs["origin"])
        except (KeyError, TypeError, ValueError):
            continue
        out.setdefault(origin, []).append(((t1 - t0) + (t2 - t3)) / 2.0)
    return out


def _max_id(events: Iterable[Event]) -> int:
    return max((max(e.span, e.parent) for e in events), default=0)


def _close_torn(events: list[Event]) -> tuple[list[Event], int]:
    """Synthesize exit events for spans a dead process left open.

    ``resolve_spans`` closes an unpaired spawn at the *whole* event list's
    last timestamp; after stitching, that attributes the merged fleet's
    remaining lifetime to a span whose process was SIGKILLed long before.
    Cap each input's open spans at that input's own last event instead —
    the latest instant the process was provably alive — and flag the spawn
    payload (``torn: true``) so consumers can tell a salvaged span from a
    clean close.
    """
    open_by_key: dict[Any, list[int]] = {}
    stack_by_name: dict[str, list[int]] = {}
    for i, e in enumerate(events):
        if e.kind == "spawn":
            key = _pair_key(e)
            if key is not None:
                open_by_key.setdefault((e.name, key), []).append(i)
            else:
                stack_by_name.setdefault(e.name, []).append(i)
        elif e.kind == "exit":
            key = _pair_key(e)
            opened = open_by_key.get((e.name, key)) if key is not None else None
            if opened:
                opened.pop()
            elif key is None and stack_by_name.get(e.name):
                stack_by_name[e.name].pop()
    idxs = ([i for lst in open_by_key.values() for i in lst]
            + [i for lst in stack_by_name.values() for i in lst])
    if not idxs:
        return events, 0
    t_last = max(e.t for e in events)
    out = list(events)
    tails: list[Event] = []
    for i in idxs:
        s = out[i]
        if isinstance(s.payload, dict):
            out[i] = dataclasses.replace(s, payload={**s.payload, "torn": True})
        tails.append(Event(t_last, "exit", s.name, out[i].payload,
                           s.span, s.parent))
    return out + tails, len(idxs)


# -- the merge ----------------------------------------------------------------


def stitch_sessions(inputs: list[tuple[str, Session]], *,
                    skew_correct: bool = True) -> Session:
    """Merge loaded sessions into one; the first input is the reference
    (its wall clock is the merged timeline, its span ids keep their values,
    and its handshake records drive skew estimation) — pass the frontdoor
    session first.
    """
    if not inputs:
        raise ValueError("stitch needs at least one input session")
    ref = inputs[0][1]
    skews = _handshake_skews(ref) if skew_correct else {}

    merged: list[Event] = []
    origin_offset: dict[str, int] = {}
    records: list[dict[str, Any]] = []
    skipped: list[dict[str, Any]] = []
    base = 0  # all ids assigned so far are <= base
    for i, (path, sess) in enumerate(inputs):
        origin = str(sess.meta.get("origin") or f"proc{i}")
        if origin in origin_offset:
            skipped.append({"path": path, "origin": origin,
                            "reason": "duplicate origin"})
            continue
        offset = base  # reference keeps its ids (base starts at 0)
        hi = _max_id(sess.events)
        clock_off = _clock_offset(sess)
        skew = (statistics.median(skews[origin])
                if origin in skews and i > 0 else 0.0)
        shift = clock_off - skew
        origin_offset[origin] = offset
        base += hi
        capped, torn = _close_torn(list(sess.events))
        for e in capped:
            merged.append(dataclasses.replace(
                e, t=e.t + shift,
                span=e.span + offset if e.span else 0,
                parent=e.parent + offset if e.parent else 0))
        records.append({
            "path": path, "origin": origin, "events": len(sess.events),
            "id_offset": offset, "span_ids": [offset + 1, offset + hi],
            "clock_offset_s": round(clock_off, 6),
            "skew_s": round(skew, 6),
            "torn_spans": torn,
        })

    # re-link remote parents: a spawn/exit pair whose payload names a
    # remote (origin, span) now has that parent in the shared id space
    relinked = 0
    unmatched = 0
    for i, e in enumerate(merged):
        ref_p = remote_ref(e.payload)
        if ref_p is None:
            continue
        off = origin_offset.get(str(ref_p["origin"]))
        if off is None:
            unmatched += 1 if e.kind == "spawn" else 0
            continue
        merged[i] = dataclasses.replace(e, parent=ref_p["span"] + off)
        relinked += 1 if e.kind == "spawn" else 0
    merged.sort(key=lambda e: e.t)

    meta = dict(ref.meta)
    meta["stitch"] = {
        "inputs": records,
        "skipped": skipped,
        "relinked_spans": relinked,
        "unmatched_remote": unmatched,
        "events": len(merged),
        "skew_corrected": bool(skew_correct),
    }
    return Session(
        meta=meta, events=merged,
        dropped=sum(s.dropped for _, s in inputs),
        capacity=ref.capacity,
        decisions=[d for _, s in inputs for d in s.decisions],
        store=ref.store, chip=ref.chip,
        collector_stats=ref.collector_stats,
    )


def stitch(paths: list[str], *, skew_correct: bool = True,
           discover: bool = True) -> Session:
    """Load and merge sessions/streaming dirs (frontdoor first).

    With ``discover`` (default), a frontdoor streaming session's announced
    replica dirs are appended automatically — ``repro_torch.trace stitch
    <frontdoor-dir>`` alone stitches the whole fleet.
    """
    from repro_torch.trace.stream import load_any

    paths = list(paths)
    if discover:
        for d in discover_inputs(paths[0]):
            if d not in paths:
                paths.append(d)
    return stitch_sessions([(p, load_any(p)) for p in paths],
                           skew_correct=skew_correct)


# -- chain + hop analysis -----------------------------------------------------


def _span_children(spans: list[Span]) -> dict[int, list[Span]]:
    kids: dict[int, list[Span]] = {}
    for s in spans:
        if s.parent:
            kids.setdefault(s.parent, []).append(s)
    return kids


def chain_report(session: Session) -> dict[str, Any]:
    """Cross-process chain coverage: of the completed requests (terminal
    outcome ``ok``/``retried``), how many have a full frontdoor → replica
    chain — request → route → (re-linked) rpc → engine request?

    ``broken`` samples up to 10 unchained requests (outcome payloads) for
    debugging; ``orphaned_remote`` counts rpc spans whose remote parent
    never resolved (origin missing from the stitched inputs).
    """
    spans = resolve_spans(session.events)
    kids = _span_children(spans)
    completed = 0
    chained = 0
    broken: list[dict[str, Any]] = []
    for s in spans:
        p = s.payload
        if (s.name != "outcome" or not isinstance(p, dict)
                or p.get("outcome") not in ("ok", "retried")):
            continue
        completed += 1
        ok = False
        for route in kids.get(s.parent, []):
            if route.name != "route":
                continue
            for rpc in kids.get(route.span, []):
                if rpc.name == "rpc" and any(
                        c.name == "request" for c in kids.get(rpc.span, [])):
                    ok = True
        if ok:
            chained += 1
        elif len(broken) < 10:
            broken.append(p)
    orphaned = sum(1 for s in spans
                   if s.remote is not None
                   and str(s.remote.get("origin")) not in
                   {r["origin"] for r in
                    (session.meta.get("stitch") or {}).get("inputs", [])})
    return {
        "completed": completed,
        "chained": chained,
        "fraction": (chained / completed) if completed else 0.0,
        "orphaned_remote": orphaned,
        "broken": broken,
    }


def hop_rows(session: Session) -> list[dict[str, Any]]:
    """One row per completed request carrying a hop decomposition:
    ``{hops: {...}, latency_ms, sum_ms, replica, outcome}``."""
    rows: list[dict[str, Any]] = []
    for e in session.events:
        p = e.payload
        if (e.kind != "route" or e.name != "outcome"
                or not isinstance(p, dict)
                or not isinstance(p.get("hops"), dict)):
            continue
        hops = {h: float(p["hops"].get(h, 0.0)) for h in HOPS}
        rows.append({
            "hops": hops,
            "latency_ms": float(p.get("latency_ms") or 0.0),
            "sum_ms": sum(hops.values()),
            "replica": p.get("replica"),
            "outcome": p.get("outcome"),
        })
    return rows


def hop_summary(rows: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate hop stats + the sum-vs-latency consistency check."""
    def stats(vals: list[float]) -> dict[str, float]:
        if not vals:
            return {"count": 0}
        vs = sorted(vals)
        return {
            "count": len(vs),
            "mean": sum(vs) / len(vs),
            "p50": vs[len(vs) // 2],
            "p95": vs[min(len(vs) - 1, int(len(vs) * 0.95))],
            "max": vs[-1],
        }

    within = sum(1 for r in rows
                 if r["latency_ms"] > 0
                 and abs(r["sum_ms"] - r["latency_ms"]) <= 0.05 * r["latency_ms"])
    return {
        "requests": len(rows),
        "within_5pct": within,
        "hops": {h: stats([r["hops"][h] for r in rows]) for h in HOPS},
        "latency_ms": stats([r["latency_ms"] for r in rows]),
    }


def merge_for_report(paths: list[str]) -> Session:
    """Load N sessions for one ``report`` invocation without id collisions.

    The namespacing/re-linking machinery of :func:`stitch_sessions` with
    discovery and skew estimation as stitch defaults — loading two sessions
    from different processes previously cross-linked their span ids
    silently (span id 7 of the frontdoor adopted span id 7's children from
    the replica).
    """
    return stitch(paths)


__all__ = [
    "HOPS", "chain_report", "discover_inputs", "hop_rows", "hop_summary",
    "merge_for_report", "stitch", "stitch_sessions",
]
