"""Device-timeline adapter: fold ``torch.profiler`` windows under host spans.

Counterpart of ``repro/trace/device.py``, with the same API
(:class:`DeviceSlice`, :func:`load_profiler_trace`,
:func:`align_device_slices`, :func:`alignment_summary`,
:func:`merge_device_trace`), over the Chrome trace that ``torch.profiler``
writes (``prof.export_chrome_trace``, Kineto's format).  The collector only
sees *host* lifecycle events; the profiler window adds what the card ran
inside them.  Merged slices become ``device``-kind events parented to the
host span that launched them, so ``report --tree`` shows the kernels under
the request, tick or step that caused them.

Where the JAX adapter differs from this one:

* **Which rows are device rows**: those of Kineto's device categories
  (:data:`DEVICE_CATEGORIES`: ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
  not process names.  A trace with none raises :class:`NoDeviceRows`
  (carrying the number of host launch calls it saw), never a set of host
  slices passed off as device time.
* **Alignment by launch, not by device time**: a kernel runs after its host
  launch, asynchronously, so the span open when it happens to run is not
  the one that launched it.  Each device row is bound, through its
  ``correlation`` id, to the runtime or driver call that launched it
  (``cudaLaunchKernel``; ``cuLaunchKernel`` for the kernels launched through
  ctypes; ``cudaGraphLaunch`` for a replay, whose kernel nodes all share its
  correlation, so a whole graph binds to the tick or step that replayed it),
  and then to the innermost ``span=<id>`` range open on that host thread at
  the launch (``device_annotation`` in :mod:`repro_torch.trace.liveprof`):
  mode ``"span"``.  A launch under no such range (or whose span the
  collector shed) binds to the collector's innermost host span open at the
  launch's host time: mode ``"launch"``.  Rows that carry no launch (the
  synthetic backend's) fall back to the JAX rule, the slice's midpoint
  inside a host span: mode ``"window"``; what matches nothing is ``"none"``.
* **Clock**: Kineto's timestamps share no epoch with ``time.monotonic()``.
  The offset is the median, over the trace's ``span=<id>`` ranges whose span
  the host events hold, of the span's host start minus the range's start;
  the trace starts are never aligned.  ``offset_s`` overrides it (the
  synthetic backend writes host-monotonic times, offset 0).
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
import statistics
from typing import Any, Iterable, Optional

from repro_torch.core.events import Event
from repro_torch.trace.collector import resolve_spans

DEVICE_KIND = "device"

# Kineto's categories of rows that ran on the card
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# host rows of the CUDA runtime and driver APIs (launches, copies, syncs)
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})
# a launch call: the APIs that put work on the card
_LAUNCH_NAME_RE = re.compile(r"Launch|Memcpy|Memset", re.IGNORECASE)
_SPAN_HINT_RE = re.compile(r"\bspan[=:](\d+)\b")
_SPAN_RANGE_RE = re.compile(r"^span=(\d+)$")
ALIGN_MODES = ("span", "launch", "window", "none")


class NoDeviceRows(ValueError):
    """A profiler trace holds no device rows.  ``launches`` counts the host
    launch calls it recorded: more than 0 means the card ran work the
    window did not see (a session without the card's activity)."""

    def __init__(self, path: str, launches: int) -> None:
        super().__init__(f"no device rows ({', '.join(sorted(DEVICE_CATEGORIES))}) in "
                         f"{path}; {launches} host launch calls recorded")
        self.launches = launches


@dataclasses.dataclass(frozen=True)
class DeviceSlice:
    """One device row of a profiler trace, in the trace's clock (seconds).

    ``launch`` / ``launch_t`` are the host call that launched it and its
    start; ``span_t`` is the start of the ``span=<id>`` range the launch
    was bound to (its id in ``args["span"]``)."""

    name: str
    t0: float
    t1: float
    device: str
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    launch: str = ""
    launch_t: Optional[float] = None
    span_t: Optional[float] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    @property
    def span_hint(self) -> int:
        """Host span id of the annotation the slice was launched under (or
        that its name carries), 0 when absent."""
        v = self.args.get("span")
        if isinstance(v, int) and v > 0:
            return v
        for text in (str(v) if v is not None else "", self.name):
            m = _SPAN_HINT_RE.search(text)
            if m:
                return int(m.group(1))
        return 0


@dataclasses.dataclass
class ProfilerWindow:
    """What one or more trace files of a window hold: the device slices, the
    ``span=<id>`` ranges as (span id, start s), and the host launch calls."""

    slices: list[DeviceSlice]
    ranges: list[tuple[int, float]]
    launches: int


def _find_trace_files(path: str) -> list[str]:
    """Resolve a window directory (or one file) to its chrome trace file(s):
    a window cut around a CUDA graph capture holds one per segment."""
    if os.path.isfile(path):
        return [path]
    for pattern in ("*.trace.json.gz", "*.trace.json", "*.json.gz", "*.json"):
        hits = sorted(glob.glob(os.path.join(path, "**", pattern), recursive=True))
        if hits:
            return hits
    raise FileNotFoundError(f"no chrome trace (*.trace.json[.gz]) under {path}")


def _innermost(ranges: list[tuple[float, float, int]],
               queries: list[tuple[float, int]]) -> dict[int, tuple[int, float]]:
    """For each (time, key) query, the innermost of one thread's properly
    nested (t0, t1, span) ranges open at that time: key -> (span, t0)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: dict[int, tuple[int, float]] = {}
    stack: list[tuple[float, float, int]] = []
    ri = 0
    for t, key in sorted(queries):
        while ri < len(ranges) and ranges[ri][0] <= t:
            while stack and stack[-1][1] < ranges[ri][0]:
                stack.pop()
            stack.append(ranges[ri])
            ri += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = (stack[-1][2], stack[-1][0])
    return out


def _parse_trace_file(file: str) -> ProfilerWindow:
    opener = gzip.open if file.endswith(".gz") else open
    with opener(file, "rt") as f:
        doc = json.load(f)
    rows = doc["traceEvents"] if isinstance(doc, dict) else doc
    pid_names: dict[Any, str] = {}
    device_rows, launches, thread_ranges = [], {}, {}
    ranges: list[tuple[int, float]] = []
    n_launch = 0
    for r in rows:
        ph = r.get("ph")
        if ph == "M" and r.get("name") == "process_name":
            pid_names[r.get("pid")] = str((r.get("args") or {}).get("name", ""))
            continue
        if ph != "X" or not isinstance(r.get("ts"), (int, float)):
            continue
        cat = r.get("cat")
        args = r.get("args") or {}
        if cat in DEVICE_CATEGORIES:
            device_rows.append(r)
        elif cat in LAUNCH_CATEGORIES:
            name = str(r.get("name", ""))
            if _LAUNCH_NAME_RE.search(name):
                n_launch += 1
            corr = args.get("correlation")
            if isinstance(corr, int):
                launches[corr] = r
        elif not str(cat).startswith("gpu_"):  # gpu_user_annotation: a device-side copy
            m = _SPAN_RANGE_RE.match(str(r.get("name", "")))
            if m:
                t0 = r["ts"] * 1e-6
                sid = int(m.group(1))
                thread_ranges.setdefault((r.get("pid"), r.get("tid")), []).append(
                    (t0, t0 + (r.get("dur", 0) or 0) * 1e-6, sid))
                ranges.append((sid, t0))
    # bind each launch call to the innermost span= range open on its thread
    queries: dict[Any, list[tuple[float, int]]] = {}
    for corr, r in launches.items():
        queries.setdefault((r.get("pid"), r.get("tid")), []).append((r["ts"] * 1e-6, corr))
    bound: dict[int, tuple[int, float]] = {}
    for thread, qs in queries.items():
        bound.update(_innermost(thread_ranges.get(thread, []), qs))
    out: list[DeviceSlice] = []
    for r in device_rows:
        args = r.get("args") or {}
        t0 = r["ts"] * 1e-6
        dev = args.get("device")
        device = pid_names.get(r.get("pid")) if not isinstance(dev, int) else f"cuda:{dev}"
        corr = args.get("correlation")
        keep = {k: args[k] for k in ("correlation", "stream") if isinstance(args.get(k), int)}
        launch = launches.get(corr) if isinstance(corr, int) else None
        span_t = None
        if isinstance(corr, int) and corr in bound:
            keep["span"], span_t = bound[corr]
        out.append(DeviceSlice(
            name=str(r.get("name", "?")), t0=t0, t1=t0 + (r.get("dur", 0) or 0) * 1e-6,
            device=device or f"pid:{r.get('pid')}", args=keep,
            launch=str(launch.get("name", "")) if launch else "",
            launch_t=launch["ts"] * 1e-6 if launch else None, span_t=span_t,
        ))
    return ProfilerWindow(out, ranges, n_launch)


def load_window(path: str) -> ProfilerWindow:
    """Parse every trace file of a window (a file or a directory) into one
    :class:`ProfilerWindow`; raises :class:`NoDeviceRows` if none of them
    holds a device row."""
    win = ProfilerWindow([], [], 0)
    for file in _find_trace_files(path):
        part = _parse_trace_file(file)
        win.slices.extend(part.slices)
        win.ranges.extend(part.ranges)
        win.launches += part.launches
    if not win.slices:
        raise NoDeviceRows(path, win.launches)
    win.slices.sort(key=lambda s: s.t0)
    return win


def load_profiler_trace(path: str) -> list[DeviceSlice]:
    """The device slices of a ``torch.profiler`` trace (a file, or a window
    directory whose files are merged), each bound to its launch and the
    ``span=`` range around it; raises :class:`NoDeviceRows` when there is
    no device row."""
    return load_window(path).slices


def estimate_offset(host_events: Iterable[Event], ranges: Iterable[tuple[int, float]]) -> float:
    """Seconds to add to the trace's clock to land on ``time.monotonic()``:
    the median over the ``span=<id>`` ranges whose span the host events
    hold of (the span's host start − the range's start)."""
    starts = {s.span: s.t0 for s in resolve_spans(sorted(host_events, key=lambda e: e.t))
              if s.span}
    diffs = [starts[sid] - t for sid, t in ranges if sid in starts]
    if not diffs:
        raise ValueError("no span= range of the trace names a span of the host events: "
                         "the clock offset cannot be estimated (pass offset_s)")
    return statistics.median(diffs)


def align_device_slices(
    host_events: Iterable[Event],
    slices: Iterable[DeviceSlice],
    *,
    offset_s: Optional[float] = None,
    ranges: Optional[Iterable[tuple[int, float]]] = None,
    id_alloc: Optional[Any] = None,
    stats: Optional[dict[str, int]] = None,
) -> list[Event]:
    """Turn profiler slices into ``device`` events parented to host spans.

    Each returned event has ``kind="device"``, a span id of its own and
    ``payload={"dur_s", "device", "align", "args"}`` (what
    :func:`~repro_torch.trace.collector.resolve_spans` and the exporters
    read), ``align`` one of :data:`ALIGN_MODES` (module docstring).
    ``offset_s`` defaults to :func:`estimate_offset` over ``ranges`` (else
    over the ranges the slices were bound to).  ``id_alloc`` is a zero-arg
    callable producing fresh span ids: a live merge passes
    :func:`repro_torch.core.events.next_span_id`; the default allocates
    above every id the host events mention (a post-hoc merge).  ``stats``
    accumulates counts per mode and ``total``.
    """
    host_events = sorted(host_events, key=lambda e: e.t)
    slices = list(slices)
    if not slices:
        return []
    if offset_s is None:
        if ranges is None:
            ranges = [(s.args["span"], s.span_t) for s in slices if s.span_t is not None]
        offset_s = estimate_offset(host_events, ranges)
    spans = [s for s in resolve_spans(host_events) if s.span]
    by_id = {s.span: s for s in spans}

    if id_alloc is None:
        base = 1 + max((max(e.span, e.parent) for e in host_events), default=0)
        counter = iter(range(base, base + len(slices)))
        id_alloc = lambda: next(counter)  # noqa: E731

    owners: dict[int, int] = {}
    modes: dict[int, str] = {}
    # the rest by host time: the launch's, else the slice's midpoint
    queries: list[tuple[float, int]] = []
    for i, sl in enumerate(slices):
        hint = sl.span_hint
        if hint and hint in by_id:
            owners[i], modes[i] = hint, "span"
        elif sl.launch_t is not None:
            queries.append((sl.launch_t + offset_s, i))
            modes[i] = "launch"
        else:
            queries.append(((sl.t0 + sl.t1) / 2 + offset_s, i))
            modes[i] = "window"
    # innermost containing span by one time sweep (10k+ slices a window)
    starts = sorted(spans, key=lambda s: s.t0)
    active: dict[int, Any] = {}
    si = 0
    for t, i in sorted(queries):
        while si < len(starts) and starts[si].t0 <= t:
            active[starts[si].span] = starts[si]
            si += 1
        for sid in [sid for sid, s in active.items() if s.t1 < t]:
            del active[sid]
        if active:
            owners[i] = min(active.values(), key=lambda s: s.dur).span
        else:
            owners[i], modes[i] = 0, "none"

    out: list[Event] = []
    for i, sl in enumerate(slices):
        t0, t1 = sl.t0 + offset_s, sl.t1 + offset_s
        payload: dict[str, Any] = {"dur_s": max(0.0, t1 - t0),
                                   "device": sl.device, "align": modes[i]}
        args = {k: v for k, v in sl.args.items() if isinstance(v, (int, float, str, bool))}
        if sl.launch:
            args["launch"] = sl.launch
        if args:
            payload["args"] = args
        out.append(Event(t0, DEVICE_KIND, sl.name, payload,
                         span=id_alloc(), parent=owners[i]))
        if stats is not None:
            stats[modes[i]] = stats.get(modes[i], 0) + 1
            stats["total"] = stats.get("total", 0) + 1
    return out


def alignment_summary(events: Iterable[Event]) -> dict[str, Any]:
    """Per-mode counts + annotated fraction over merged ``device`` events."""
    counts = {mode: 0 for mode in ALIGN_MODES}
    counts["total"] = 0
    for e in events:
        if e.kind != DEVICE_KIND or not isinstance(e.payload, dict):
            continue
        mode = e.payload.get("align")
        if mode not in counts:
            mode = "none"
        counts[mode] += 1
        counts["total"] += 1
    counts["annotated_fraction"] = (
        counts["span"] / counts["total"] if counts["total"] else 0.0
    )
    return counts


def merge_device_trace(
    session: Any, path: str, *, offset_s: Optional[float] = None
) -> int:
    """Merge a profiler window (file or directory) into a loaded Session, in
    place.  Returns the number of device events merged; records the path,
    count and per-mode alignment stats under ``session.meta["device_trace"]``."""
    stats: dict[str, int] = {}
    win = load_window(path)
    merged = align_device_slices(session.events, win.slices, offset_s=offset_s,
                                 ranges=win.ranges, stats=stats)
    session.events = sorted(session.events + merged, key=lambda e: e.t)
    session.meta["device_trace"] = {
        "path": path, "events": len(merged), "align": stats,
    }
    return len(merged)
