"""Run snapshots: one JSON file per run, reloadable across processes
(counterpart of ``repro/trace/session.py``; the same file format, so a
session written by either package loads, reports and diffs in the other).

A *session* is everything a later analysis (or a warm-started dispatcher)
needs from a run: the event trace, every dispatch decision, the measured
:class:`~repro_torch.dispatch.profiles.ProfileStore`, the chip model it was priced
against, and provenance metadata (schema version, git SHA, wall-clock
timestamp, argv).  ``launch.serve --trace-out t.json`` writes one;
``python -m repro_torch.trace {report,export,diff}`` consumes them; ``--profile-in``
feeds the stored profiles back into a new dispatcher so it skips the
exploration phase entirely (the measured warm-start crossover), from a
session or a bare store file of either package, after
:func:`age_out_profiles` dropped the entries of other code or another chip
(a store of TPU samples never steers dispatch on the card).  The chip a
bench artifact is stamped with is ``hw/specs.default_chip()``
(``h100_sxm``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from typing import Any, Optional

from repro_torch.core.events import Event, EventLog
from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.trace.collector import Span, SpanNode, resolve_spans, span_tree

SESSION_SCHEMA = "repro.trace.session/v1"
ARTIFACT_SCHEMA = "repro.bench/v1"


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Short SHA of the checkout this module lives in ("unknown" outside git)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def run_metadata(extra: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    """Provenance stamp shared by sessions and bench artifacts."""
    meta = {
        "git_sha": git_sha(),
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        # paired monotonic/wall samples taken at the same instant: the clock
        # anchor stitch uses to map this process's event timestamps
        # (monotonic, arbitrary epoch) onto a shared wall-clock timeline
        "clock": {"monotonic": time.monotonic(), "unix": time.time()},
    }
    if extra:
        meta.update(extra)
    return meta


def artifact_meta(extra: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    """Stamp for benchmark output JSON (``repro_torch.trace diff``-comparable)."""
    from repro_torch.hw.specs import default_chip

    meta = {"schema": ARTIFACT_SCHEMA, **run_metadata(extra)}
    meta["chip"] = dataclasses.asdict(default_chip())
    return meta


def _sanitize(obj: Any) -> Any:
    """Round-trip ``obj`` through JSON semantics (repr for the unencodable)."""
    return json.loads(json.dumps(obj, default=repr))


@dataclasses.dataclass
class Session:
    """An in-memory run snapshot (see module docstring for the file story)."""

    meta: dict[str, Any]
    events: list[Event]
    dropped: int = 0
    capacity: Optional[int] = None
    decisions: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    store: Optional[ProfileStore] = None
    chip: Optional[dict[str, Any]] = None
    collector_stats: Optional[dict[str, Any]] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def capture(
        cls,
        log: EventLog,
        *,
        dispatcher: Any = None,
        store: Optional[ProfileStore] = None,
        meta: Optional[dict[str, Any]] = None,
        collector_stats: Optional[dict[str, Any]] = None,
    ) -> "Session":
        """Snapshot a live run.

        ``dispatcher`` (a :class:`repro_torch.dispatch.dispatcher.Dispatcher`)
        contributes its decisions, profile store and chip model; any of the
        three can also be absent (trace-only runs).  ``collector_stats``
        (``TraceCollector.stats()``) rides along so drop accounting survives
        serialisation; when omitted it is pulled from the log if available.
        """
        decisions: list[dict[str, Any]] = []
        chip = None
        if dispatcher is not None:
            decisions = [d.payload() for d in dispatcher.decisions]
            store = store if store is not None else dispatcher.store
            chip = dataclasses.asdict(dispatcher.chip)
        if collector_stats is None:
            stats_fn = getattr(log, "stats", None)
            if callable(stats_fn):
                collector_stats = stats_fn()
        return cls(
            meta={"schema": SESSION_SCHEMA, **run_metadata(meta)},
            events=log.events(),
            dropped=log.dropped,
            capacity=log.maxlen,
            decisions=decisions,
            store=store,
            chip=chip,
            collector_stats=collector_stats,
        )

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return _sanitize({
            "meta": self.meta,
            "trace": {
                "dropped": self.dropped,
                "capacity": self.capacity,
                "stats": self.collector_stats,
                "events": [dataclasses.asdict(e) for e in self.events],
            },
            "dispatch": {
                "decisions": self.decisions,
                "profiles": json.loads(self.store.to_json()) if self.store else None,
                "chip": self.chip,
            },
        })

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Session":
        trace = raw.get("trace", {})
        disp = raw.get("dispatch", {})
        profiles = disp.get("profiles")
        return cls(
            meta=raw.get("meta", {}),
            events=[Event(**row) for row in trace.get("events", [])],
            dropped=trace.get("dropped", 0),
            capacity=trace.get("capacity"),
            decisions=disp.get("decisions", []),
            store=ProfileStore.from_json(json.dumps(profiles)) if profiles else None,
            chip=disp.get("chip"),
            collector_stats=trace.get("stats"),
        )

    @classmethod
    def load(cls, path: str) -> "Session":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- analysis ------------------------------------------------------------

    def spans(self) -> list[Span]:
        return resolve_spans(sorted(self.events, key=lambda e: e.t))

    def span_tree(self) -> list[SpanNode]:
        """The session's spans folded into a parent-linked forest."""
        return span_tree(self.spans())

    def tree_report(self) -> list[dict[str, Any]]:
        """Aggregated span-tree rows (the ``report --tree`` view).

        Sibling spans are grouped by (track, name) at each depth — a serve
        run shows one ``request`` row with count 12, its ``prefill`` child
        row, and the ``dispatch`` decisions nested below — with inclusive
        (span duration) and exclusive (minus children) totals per node.
        """
        rows: list[dict[str, Any]] = []

        def visit(nodes: list[SpanNode], depth: int) -> None:
            groups: dict[tuple[str, str], list[SpanNode]] = {}
            for n in nodes:
                groups.setdefault((n.span.track, n.span.name), []).append(n)
            for (track, name), ns in sorted(
                groups.items(), key=lambda kv: min(x.span.t0 for x in kv[1])
            ):
                rows.append({
                    "depth": depth,
                    "track": track,
                    "name": name,
                    "count": len(ns),
                    "inclusive_ms": sum(n.span.dur for n in ns) * 1e3,
                    "exclusive_ms": sum(n.exclusive for n in ns) * 1e3,
                    "truncated": sum(1 for n in ns if n.span.truncated),
                })
                visit([c for n in ns for c in n.children], depth + 1)

        visit(self.span_tree(), 0)
        return rows

    def path_report(self, max_depth: int = 4) -> dict[str, dict[str, Any]]:
        """Exclusive time aggregated per span-tree *path* (depth-capped).

        A path is the ``/``-joined chain of span names from a root down
        (``request/prefill/matmul``); nodes deeper than ``max_depth`` fold
        their exclusive time into their depth-capped ancestor, so totals are
        conserved whatever the cap.  Truncated spans contribute their
        (force-closed) children's structure but no time of their own — a cut
        exit is not a measurement.
        """
        out: dict[str, dict[str, Any]] = {}

        def visit(node: SpanNode, names: tuple[str, ...]) -> None:
            names = names + (node.span.name,)
            capped = names[:max_depth]
            path = "/".join(capped)
            row = out.setdefault(path, {"count": 0, "exclusive_ms": 0.0,
                                        "truncated": 0, "depth": len(capped)})
            if node.span.truncated:
                row["truncated"] += 1
            else:
                row["exclusive_ms"] += node.exclusive * 1e3
                if len(names) <= max_depth:
                    row["count"] += 1
            for c in node.children:
                visit(c, names)

        for root in self.span_tree():
            visit(root, ())
        return {p: r for p, r in out.items() if r["count"] or r["truncated"]}

    def report(self) -> dict[str, Any]:
        """Deterministic per-op / per-backend tables (the CLI renders these).

        Computed only from serialised fields, so ``save → load → report`` is
        bit-identical to reporting the live session.
        """
        spans = self.spans()
        lat: dict[str, dict[str, float]] = {}
        truncated = 0
        for s in spans:
            if s.truncated:
                # force-closed at an arbitrary cut point, not a measurement:
                # one evicted exit would otherwise inflate mean/max by the
                # whole remaining run and trip the diff --fail-over-pct gate
                truncated += 1
                continue
            if s.dur <= 0:
                continue
            row = lat.setdefault(f"{s.track}/{s.name}", {"count": 0, "total_ms": 0.0,
                                                         "min_ms": float("inf"), "max_ms": 0.0})
            ms = s.dur * 1e3
            row["count"] += 1
            row["total_ms"] += ms
            row["min_ms"] = min(row["min_ms"], ms)
            row["max_ms"] = max(row["max_ms"], ms)
        for row in lat.values():
            row["mean_ms"] = row["total_ms"] / row["count"]

        by_op: dict[str, dict[str, dict[str, float]]] = {}
        by_source: dict[str, int] = {}
        for d in self.decisions:
            op, backend = d.get("op", "?"), d.get("backend", "?")
            cell = by_op.setdefault(op, {}).setdefault(
                backend, {"count": 0, "total_ms": 0.0, "measured": 0}
            )
            cell["count"] += 1
            if isinstance(d.get("measured_s"), (int, float)):
                cell["measured"] += 1
                cell["total_ms"] += d["measured_s"] * 1e3
            src = d.get("source", "?")
            by_source[src] = by_source.get(src, 0) + 1
        for backends in by_op.values():
            for cell in backends.values():
                cell["mean_ms"] = cell["total_ms"] / cell["measured"] if cell["measured"] else None

        cstats = self.collector_stats or {}
        return {
            "meta": {k: self.meta.get(k) for k in ("schema", "git_sha", "created_unix")},
            "events": len(self.events),
            "dropped": self.dropped,
            # loss accounting at top level: a report whose rings shed events
            # should say so up front, not three dicts deep in session meta
            "dropped_by_track": {k: v for k, v in
                                 (cstats.get("dropped_by_track") or {}).items() if v},
            "sampled_out": cstats.get("sampled_out", 0),
            "truncated_spans": truncated,
            "latency": lat,
            "dispatch": {
                "decisions": len(self.decisions),
                "by_op": by_op,
                "by_source": by_source,
                "profiled_keys": len(self.store) if self.store else 0,
            },
        }


def is_session(raw: dict[str, Any]) -> bool:
    return raw.get("meta", {}).get("schema") == SESSION_SCHEMA


def load_profile_store(path: str) -> ProfileStore:
    """Read a ProfileStore from a session file OR a bare store JSON file."""
    with open(path) as f:
        raw = json.load(f)
    if is_session(raw):
        profiles = raw.get("dispatch", {}).get("profiles")
        if not profiles:
            raise ValueError(f"session {path} carries no profile store")
        return ProfileStore.from_json(json.dumps(profiles))
    if "entries" not in raw:
        # reject arbitrary JSON (a chrome export, a bench artifact, …): a
        # silently-empty store would make --profile-in a no-op with no signal
        raise ValueError(
            f"{path} is neither a trace session nor a ProfileStore JSON "
            "(expected an 'entries' key)"
        )
    return ProfileStore.from_json(json.dumps(raw))


def load_profile_stores(paths: list[str]) -> ProfileStore:
    """Load one or more profile files and merge them into a single store."""
    stores = [load_profile_store(p) for p in paths]
    base = stores[0]
    for s in stores[1:]:
        base.merge(s)
    return base


def age_out_profiles(store: ProfileStore, chip_name: str) -> list[dict[str, str]]:
    """Invalidate ``--profile-in`` entries measured on different code/hardware.

    Compares each entry's git SHA / chip stamp against the *current* repo SHA
    and the given chip, evicting mismatches so the dispatcher re-explores
    instead of trusting stale timings.  Every eviction is logged to stderr
    with its reason (drivers surface the count in their JSON output).
    """
    aged = store.age_out(git_sha=git_sha(), chip=chip_name)
    for a in aged:
        print(f"profile-in: aged out {a['key']}: {a['reason']}", file=sys.stderr)
    return aged


# -- diffing ----------------------------------------------------------------


def diff_sessions(a: Session, b: Session) -> dict[str, Any]:
    """Per-key latency + dispatch-choice deltas between two sessions."""
    ra, rb = a.report(), b.report()
    lat: dict[str, Any] = {}
    for key in sorted(set(ra["latency"]) | set(rb["latency"])):
        la, lb = ra["latency"].get(key), rb["latency"].get(key)
        if la and lb:
            lat[key] = {
                "a_mean_ms": la["mean_ms"], "b_mean_ms": lb["mean_ms"],
                "delta_pct": (lb["mean_ms"] / la["mean_ms"] - 1.0) * 100 if la["mean_ms"] else None,
            }
        else:
            lat[key] = {"only_in": "a" if la else "b"}

    def modal_backend(rep: dict, op: str) -> Optional[str]:
        cells = rep["dispatch"]["by_op"].get(op)
        return max(cells, key=lambda b: cells[b]["count"]) if cells else None

    choices: dict[str, Any] = {}
    ops = set(ra["dispatch"]["by_op"]) | set(rb["dispatch"]["by_op"])
    for op in sorted(ops):
        ca, cb = modal_backend(ra, op), modal_backend(rb, op)
        choices[op] = {"a": ca, "b": cb, "changed": ca != cb}
    return {
        "a": ra["meta"], "b": rb["meta"],
        "latency": lat,
        "dispatch_choices": choices,
        "by_source": {"a": ra["dispatch"]["by_source"], "b": rb["dispatch"]["by_source"]},
    }


def path_diff(a: Session, b: Session, max_depth: int = 4) -> list[dict[str, Any]]:
    """Diff mean exclusive time per span-tree path (``diff --by-path``).

    Attributes a regression to the tree node that actually grew rather than
    the whole request: a slower ``request/prefill/matmul`` shows up on that
    path, while ``request`` itself (exclusive of children) stays flat.
    Rows are sorted most-changed first; paths present on only one side are
    reported but carry no delta.
    """
    ra, rb = a.path_report(max_depth), b.path_report(max_depth)
    rows: list[dict[str, Any]] = []
    for path in sorted(set(ra) | set(rb)):
        pa, pb = ra.get(path), rb.get(path)
        if pa and pb and pa["count"] and pb["count"]:
            ma = pa["exclusive_ms"] / pa["count"]
            mb = pb["exclusive_ms"] / pb["count"]
            rows.append({
                "path": path,
                "a_mean_exclusive_ms": ma,
                "b_mean_exclusive_ms": mb,
                "a_count": pa["count"],
                "b_count": pb["count"],
                "delta_pct": (mb / ma - 1.0) * 100 if ma else None,
            })
        else:
            present = pa if pa else pb
            rows.append({"path": path, "only_in": "a" if pa else "b",
                         "count": present["count"] if present else 0})
    rows.sort(key=lambda r: -(abs(r["delta_pct"])
                              if isinstance(r.get("delta_pct"), (int, float))
                              else -1.0))
    return rows


def path_regressions(
    rows: list[dict[str, Any]], fail_over_pct: float
) -> list[dict[str, Any]]:
    """Regressed rows from a :func:`path_diff` (feeds the CI exit-3 gate)."""
    regs: list[dict[str, Any]] = []
    for r in rows:
        d = r.get("delta_pct")
        if isinstance(d, (int, float)) and d > fail_over_pct:
            regs.append({"key": r["path"], "a": r["a_mean_exclusive_ms"],
                         "b": r["b_mean_exclusive_ms"], "delta_pct": d,
                         "kind": "path-exclusive"})
    return regs


def _numeric_leaves(obj: Any, prefix: str = "") -> dict[str, float]:
    out: dict[str, float] = {}
    if isinstance(obj, bool):
        return out
    if isinstance(obj, (int, float)):
        out[prefix or "<root>"] = float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_numeric_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(_numeric_leaves(v, f"{prefix}[{i}]"))
    return out


def diff_artifacts(a: dict[str, Any], b: dict[str, Any], top: int = 20) -> dict[str, Any]:
    """Generic numeric diff for stamped benchmark artifacts (out_all.json).

    Skips provenance stamps (timestamps/SHAs always differ) and ranks shared
    numeric leaves by relative change.
    """
    la, lb = _numeric_leaves(a), _numeric_leaves(b)
    skip = ("meta.", "created_unix", "timestamp")
    rows = []
    for key in sorted(set(la) & set(lb)):
        if any(s in key for s in skip):
            continue
        va, vb = la[key], lb[key]
        if va == vb:
            continue
        # None, not inf, for 0 -> nonzero: json.dumps(Infinity) is not JSON
        rel = (vb / va - 1.0) * 100 if va else None
        rows.append({"key": key, "a": va, "b": vb, "delta_pct": rel})
    rows.sort(key=lambda r: -(abs(r["delta_pct"]) if r["delta_pct"] is not None else float("inf")))
    return {
        "a_meta": a.get("meta", {}).get("git_sha"),
        "b_meta": b.get("meta", {}).get("git_sha"),
        "changed": rows[:top],
        "total_changed": len(rows),
        "only_in_a": sorted(set(la) - set(lb))[:top],
        "only_in_b": sorted(set(lb) - set(la))[:top],
    }


# -- regression gating (CI) --------------------------------------------------
#
# `repro_torch.trace diff --fail-over-pct P` turns a diff into a failing check:
# latency-like metrics that grew by more than P%, or throughput-like metrics
# that shrank by more than P%, are regressions.  Keys are classified by their
# leaf name so provenance stamps and counters never trip the gate.

_THROUGHPUT_HINTS = ("per_s", "throughput", "flops")
_TIME_HINTS = ("latency", "wall", "duration")
_TIME_SUFFIXES = ("_ms", "_s", "_us", "_seconds")


def _leaf_name(key: str) -> str:
    return key.rsplit(".", 1)[-1].split("[", 1)[0].lower()


def artifact_regressions(
    a: dict[str, Any], b: dict[str, Any], fail_over_pct: float
) -> list[dict[str, Any]]:
    """Regressed time/throughput leaves between two stamped bench artifacts."""
    la, lb = _numeric_leaves(a), _numeric_leaves(b)
    skip = ("meta.", "created_unix", "timestamp")
    regs: list[dict[str, Any]] = []
    for key in sorted(set(la) & set(lb)):
        if any(s in key for s in skip):
            continue
        va, vb = la[key], lb[key]
        if va == vb or not va:
            continue
        delta = (vb / va - 1.0) * 100
        leaf = _leaf_name(key)
        if any(h in leaf for h in _THROUGHPUT_HINTS):
            if delta < -fail_over_pct:
                regs.append({"key": key, "a": va, "b": vb, "delta_pct": delta,
                             "kind": "throughput"})
        elif leaf.endswith(_TIME_SUFFIXES) or any(h in leaf for h in _TIME_HINTS):
            if delta > fail_over_pct:
                regs.append({"key": key, "a": va, "b": vb, "delta_pct": delta,
                             "kind": "latency"})
    return regs


def session_regressions(
    diff: dict[str, Any], fail_over_pct: float
) -> list[dict[str, Any]]:
    """Regressed per-track latency rows from a :func:`diff_sessions` output."""
    regs: list[dict[str, Any]] = []
    for key, row in sorted(diff.get("latency", {}).items()):
        d = row.get("delta_pct")
        if isinstance(d, (int, float)) and d > fail_over_pct:
            regs.append({"key": key, "a": row["a_mean_ms"], "b": row["b_mean_ms"],
                         "delta_pct": d, "kind": "latency"})
    return regs
