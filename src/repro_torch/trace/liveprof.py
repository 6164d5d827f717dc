"""Live device profiling: duty-cycled ``torch.profiler`` capture windows.

Counterpart of ``repro/trace/liveprof.py``.  Capture runs in **windows**
scheduled by a device-specific budget loop
(:class:`repro_torch.metrics.controller.DeviceCaptureBudget`, the JAX law).
Each window:

1. ``backend.start(dir)`` opens a profiler session (``torch.profiler`` with
   the CPU and CUDA activities for the ``torch`` backend);
2. after the planned on-time, ``backend.stop()`` writes its Chrome trace,
   which is parsed and aligned (:mod:`repro_torch.trace.device`: each
   kernel bound through its launch to the ``span=<id>`` range around it)
   against the host events recorded so far, in-process, so the span ids are
   the live ones;
3. the merged ``device`` events are recorded through the collector in one
   batch (``record_many``), into its reserved device ring, the live
   :class:`~repro_torch.trace.stream.StreamingSession` and the metrics
   plane;
4. the window's whole cost (start + stop + export + parse + align + merge,
   wall-clocked) feeds the budget loop, which narrows the window and
   stretches the time to the next one to hold the measured overhead under
   ``--trace-overhead-budget-pct``.

**Windows open and close on the serving (or training) thread, at step
boundaries**, not on a daemon thread as in the JAX package: the profiler
records the host ranges (``span=<id>``, the aten ops) of the thread that
started it only, so a window opened from another thread sees none of the
ranges that bind a kernel to its span; and the CUDA calls of a profiler's
start and stop must not run while the serving thread captures a CUDA
graph.  So the profiler attaches to the collector as an unsampled sink and
acts on the exits of the units in :data:`BOUNDARIES` (``prefill``,
``decode_tick``, ``step``): it opens a window there when the budget's off
time has passed, and closes it once the session has been on for the
planned time.  A :class:`~repro_torch.serving.compiled.CompiledStep`
captures inside :func:`capture_guard`, which stops the open session first
(the window's trace keeps one file per segment) and holds the next one off
until a boundary after the capture; time paused so does not count as on
time.  A window therefore never spans a capture.

Annotations: while a profiler is active, :func:`device_annotation` opens a
function-scope range ``span=<id>`` (``torch._C._profiler._RecordFunctionFast``,
as ``core/scopes.py``), not a ``record_function`` user annotation: the
port's kernels launch through ctypes, inside no aten op, and the profiler
links a launch only to function-scope ranges.  It dispatches no op and
launches no kernel; a graph replay runs no Python, so the range around a
replay is the caller's.

Degradation: with the ``torch`` backend on a CUDA device nothing degrades.
A window that cannot start or whose trace cannot be read, fails the run
(:meth:`LiveDeviceProfiler.stop` raises), and so does a run whose every
window with launches came back without device rows.  A window that saw
launches but no device row (a session without the card's activity) is
counted (``no_device_rows``) and merges nothing; one that saw neither is
counted ``empty``.  The ``synthetic`` backend (the JAX one's slices and
names, written by snooping the collector) is for a CPU device only: on a
CUDA device it is refused, so that it cannot stand in for the card.  On a
CPU device the ``torch`` backend's windows hold no device rows (``empty``).
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.core.events import next_span_id
from repro_torch.metrics.controller import DEFAULT_BUDGET_PCT, DeviceCaptureBudget
from repro_torch.trace.device import NoDeviceRows, align_device_slices, load_window

BACKENDS = ("auto", "torch", "synthetic")
DEFAULT_PERIOD_S = 2.0
# unit exits at which a window may open or close (the serving / training
# thread, between steps: no CUDA graph capture in progress)
BOUNDARIES = frozenset({"prefill", "decode_tick", "step"})
# a window's cost, wall-clocked by part: the profiler's start and stop (its
# export included), the trace's parse, and the alignment and merge
COST_PARTS = ("start", "stop", "parse", "align")


class DeviceCaptureUnavailable(RuntimeError):
    """No usable profiler backend."""


# -- span annotations ---------------------------------------------------------

# Annotation stamping is on only while a LiveDeviceProfiler is active: the
# engine, supervisor and dispatcher consult one module flag.
_ANNOTATE = False


def set_annotations(on: bool) -> None:
    global _ANNOTATE
    _ANNOTATE = bool(on)


def annotations_enabled() -> bool:
    return _ANNOTATE


def device_annotation(span_id: int) -> Any:
    """Context manager naming the enclosed device work after its host span:
    a ``span=<id>`` function-scope profiler range while a live profiler is
    active, a free null context otherwise (or when ``span_id`` is 0)."""
    if not _ANNOTATE or not span_id:
        return contextlib.nullcontext()
    return torch._C._profiler._RecordFunctionFast(f"span={span_id}")


# the profilers whose sessions a CUDA graph capture must not overlap
_ACTIVE: "weakref.WeakSet[LiveDeviceProfiler]" = weakref.WeakSet()


@contextlib.contextmanager
def capture_guard() -> Iterator[None]:
    """Around a CUDA graph capture: stops the open session of every active
    profiler (its window stays open, paused) and holds new sessions off
    until the capture has ended."""
    profs = list(_ACTIVE)
    for p in profs:
        p._pause()
    try:
        yield
    finally:
        for p in profs:
            p._unpause()


# -- backends -----------------------------------------------------------------


class TorchProfilerBackend:
    """``torch.profiler.profile`` sessions, each exported as a Chrome trace
    into its segment directory.  ``offset_s = None``: the aligner estimates
    the clock offset from the ``span=`` ranges.  ``strict`` on a CUDA
    device (no degradation there)."""

    name = "torch"
    offset_s: Optional[float] = None

    def __init__(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity

        self.device = device
        self.strict = device.type == "cuda"
        self.activities = [ProfilerActivity.CPU]
        if self.strict:
            self.activities.append(ProfilerActivity.CUDA)
        self._prof: Optional[Any] = None
        self._dir: Optional[str] = None

    def warm(self) -> None:
        """One empty session: the profiler's first start in a process
        initialises it (about 2 s on a CPU host), a set-up cost kept out of
        the first window's."""
        from torch.profiler import profile

        prof = profile(activities=self.activities)
        prof.start()
        prof.stop()

    def start(self, segment_dir: str) -> None:
        from torch.profiler import profile

        self._dir = segment_dir
        self._prof = profile(activities=self.activities)
        self._prof.start()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if self.strict:
            # the device rows of work still queued would miss the window
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._dir, "window.trace.json"))


class SyntheticProfilerBackend:
    """Profiler stub for CPU runs and tests: the JAX package's synthetic
    backend (the same slices and names).  During a window it snoops the
    collector and turns completed ``prefill`` / ``decode_tick`` / ``step``
    lifecycles and measured dispatch decisions into slices named
    ``span=<sid> <op>`` on ``/device:SYNTH:0``, written by ``stop()`` as a
    gzipped chrome trace whose rows carry the ``kernel`` category (the
    device rows :mod:`repro_torch.trace.device` reads).  Timestamps are
    host-monotonic, hence ``offset_s = 0``."""

    name = "synthetic"
    offset_s = 0.0
    strict = False
    device = "/device:SYNTH:0"

    def __init__(self, collector: Any,
                 op_names: tuple[str, ...] = ("prefill", "decode_tick", "step")) -> None:
        self.collector = collector
        self.op_names = frozenset(op_names)
        self._open: dict[tuple[str, int], float] = {}
        self._slices: list[tuple[str, int, float, float]] = []
        self._dir: Optional[str] = None
        self._lock = threading.Lock()

    def _on_event(self, e: Any) -> None:
        if e.kind == "spawn" and e.name in self.op_names:
            with self._lock:
                self._open[(e.name, e.span)] = e.t
        elif e.kind == "exit" and e.name in self.op_names:
            with self._lock:
                t0 = self._open.pop((e.name, e.span), None)
                if t0 is not None:
                    self._slices.append((e.name, e.span, t0, e.t))
        elif e.kind == "dispatch" and isinstance(e.payload, dict):
            dur = e.payload.get("measured_s")
            if isinstance(dur, (int, float)) and dur >= 0:
                op = str(e.payload.get("op") or e.name)
                with self._lock:
                    self._slices.append((op, e.span, e.t - dur, e.t))

    def start(self, segment_dir: str) -> None:
        self._dir = segment_dir
        with self._lock:
            self._open.clear()
            self._slices.clear()
        self.collector.add_sink(self._on_event, sampled=True)

    def stop(self) -> None:
        self.collector.remove_sink(self._on_event)
        with self._lock:
            slices = list(self._slices)
        rows: list[dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": self.device}},
        ]
        for op, span, t0, t1 in slices:
            rows.append({
                "ph": "X", "cat": "kernel", "pid": 1, "tid": 1,
                "name": f"span={span} {op}" if span else op,
                "ts": t0 * 1e6, "dur": max(0.0, t1 - t0) * 1e6,
            })
        with gzip.open(os.path.join(self._dir, "local.trace.json.gz"), "wt") as f:
            json.dump({"traceEvents": rows}, f)


def make_backend(kind: str, collector: Any, device: torch.device) -> Any:
    """Resolve a ``--torch-profile-backend`` value to a backend instance
    (``auto`` means ``torch``; ``synthetic`` is refused on a CUDA device)."""
    if kind == "synthetic":
        if device.type == "cuda":
            raise DeviceCaptureUnavailable(
                "the synthetic backend is for a CPU device only: on a CUDA device the "
                "torch backend captures the card")
        return SyntheticProfilerBackend(collector)
    if kind in ("torch", "auto"):
        return TorchProfilerBackend(device)
    raise DeviceCaptureUnavailable(
        f"unknown device-profiler backend {kind!r} (choose from {BACKENDS})")


# -- the live profiler --------------------------------------------------------


class LiveDeviceProfiler:
    """Duty-cycled device capture at step boundaries, merging each window
    into the live trace (module docstring).

    ``start()`` arms it (annotations on, the boundary sink attached);
    ``stop()`` closes an open window (so a run shorter than one period still
    merges one), exports the end-state gauges and raises if capture failed
    on a strict backend.  ``open_window()`` / ``close_window()`` are public
    and deterministic, so tests can drive windows themselves.
    ``snapshot()`` is the stream's ``device_provider``."""

    def __init__(
        self,
        collector: Any,
        out_dir: str,
        *,
        device: torch.device | str = "cpu",
        budget: Optional[DeviceCaptureBudget] = None,
        registry: Optional[Any] = None,
        backend: Any = "auto",
        budget_pct: float = DEFAULT_BUDGET_PCT,
        period_s: float = DEFAULT_PERIOD_S,
        id_alloc: Callable[[], int] = next_span_id,
    ) -> None:
        self.collector = collector
        self.out_dir = out_dir
        self.budget = budget if budget is not None else DeviceCaptureBudget(
            registry, budget_pct=budget_pct, period_s=period_s)
        self.backend_kind = backend
        self.degraded: Optional[str] = None
        self.failed: Optional[str] = None
        self.init_s = 0.0
        self.windows: list[dict[str, Any]] = []
        self.merged_events = 0
        self.no_device_rows = 0
        self.empty_windows = 0
        self.align_stats: dict[str, int] = {}
        self._id_alloc = id_alloc
        self._window_open = False
        self._session_open = False
        self._window_dir: Optional[str] = None
        self._segments = 0
        self._window_t0 = 0.0
        self._on_s = 0.0
        self._session_t0 = 0.0
        self._active_s = 0.0
        self._costs = dict.fromkeys(COST_PARTS, 0.0)
        self._next_open_t = 0.0
        self._capturing = 0
        self._started_t: Optional[float] = None
        self._last_cycle_t: Optional[float] = None
        self._in_boundary = False
        self._lock = threading.RLock()
        self._g_coverage = self._g_quality = None
        if registry is not None:
            self._g_coverage = registry.gauge(
                "repro_device_capture_coverage",
                "fraction of run wall time covered by capture windows")
            self._g_quality = registry.gauge(
                "repro_device_alignment_annotated_fraction",
                "device slices bound by span= annotation / total merged")
        os.makedirs(out_dir, exist_ok=True)
        # a backend kind, or an object with start(dir) / stop() (tests)
        self.backend = (make_backend(backend, collector, torch.device(device))
                        if isinstance(backend, str) else backend)
        self.strict = bool(getattr(self.backend, "strict", False))

    # -- failure -------------------------------------------------------------

    def _degrade(self, reason: str) -> None:
        """A strict backend records the failure (``stop`` raises it); any
        other records one warning event and the run proceeds host-side."""
        if self.degraded is not None or self.failed is not None:
            return
        if self.strict:
            self.failed = reason
        else:
            self.degraded = reason
            print(f"live device profiling disabled: {reason}; run proceeds "
                  "host-side only", file=sys.stderr)
        self.budget.capture_enabled = False
        self.budget.export()
        self.collector.record("mark", "device_window", {
            ("error" if self.strict else "warning"): f"device capture disabled: {reason}",
            "backend": self.backend_kind,
        })

    # -- sessions and windows ------------------------------------------------

    def _start_session(self) -> bool:
        sdir = os.path.join(self._window_dir, f"seg-{self._segments:02d}")
        os.makedirs(sdir, exist_ok=True)
        t0 = time.perf_counter()
        try:
            self.backend.start(sdir)
        except Exception as exc:
            self._degrade(f"{type(exc).__name__}: {exc}")
            return False
        self._costs["start"] += time.perf_counter() - t0
        self._segments += 1
        self._session_open = True
        self._session_t0 = time.monotonic()
        # a span the collector holds, with its range at the session's start:
        # the trace's clock offset is estimable even where every other span
        # of the window was shed
        sid = self._id_alloc()
        self.collector.record("mark", "device_window",
                              {"phase": "segment", "window": len(self.windows)}, span=sid)
        with device_annotation(sid):
            pass
        return True

    def _stop_session(self) -> None:
        self._session_open = False
        self._active_s += time.monotonic() - self._session_t0
        t0 = time.perf_counter()
        try:
            self.backend.stop()
        finally:
            self._costs["stop"] += time.perf_counter() - t0

    def open_window(self) -> bool:
        """Start one capture window, on for the budget's planned time; False
        if capture is off, a window is already open or a CUDA graph capture
        is in progress."""
        with self._lock:
            on_s, _ = self.budget.plan()
            if (self.degraded or self.failed or self._window_open or self._capturing
                    or on_s <= 0):
                return False
            self._window_dir = os.path.join(self.out_dir, f"window-{len(self.windows):04d}")
            os.makedirs(self._window_dir, exist_ok=True)
            self._segments = 0
            self._costs = dict.fromkeys(COST_PARTS, 0.0)
            self._active_s = 0.0
            self._on_s = on_s
            self._window_t0 = time.monotonic()
            if not self._start_session():
                return False
            self._window_open = True
            if self._started_t is None:
                self._started_t = self._window_t0
            return True

    def close_window(self) -> int:
        """Stop the open window, then parse, align and merge its trace live.

        Returns the number of device events merged into the collector; the
        window's whole cost is fed to the budget loop."""
        with self._lock:
            if not self._window_open:
                return 0
            self._window_open = False
            merged, stats, empty = 0, {}, None
            try:
                if self._session_open:
                    self._stop_session()
                t0 = time.perf_counter()
                try:
                    win = load_window(self._window_dir)
                except NoDeviceRows as exc:
                    empty = "no_device_rows" if exc.launches else "empty"
                    win = None
                t1 = time.perf_counter()
                self._costs["parse"] += t1 - t0
                if win is not None:
                    evs = align_device_slices(
                        self.collector.events(), win.slices,
                        offset_s=getattr(self.backend, "offset_s", None),
                        ranges=win.ranges, id_alloc=self._id_alloc, stats=stats)
                    self.collector.record_many(evs)
                    merged = len(evs)
                self._costs["align"] += time.perf_counter() - t1
            except Exception as exc:
                self._degrade(f"{type(exc).__name__}: {exc}")
            if empty == "no_device_rows":
                self.no_device_rows += 1
            elif empty == "empty":
                self.empty_windows += 1
            now = time.monotonic()
            cost_s = sum(self._costs.values())
            win_rec = {
                "dir": os.path.basename(self._window_dir or ""),
                "t0": round(self._window_t0, 6),
                "t1": round(now, 6),
                "on_s": round(self._active_s, 6),
                "segments": self._segments,
                "cost_s": round(cost_s, 6),
                **{f"{k}_ms": round(1e3 * v, 3) for k, v in self._costs.items()},
                "events": merged,
                "align": stats,
            }
            if empty:
                win_rec["empty"] = empty
            self.windows.append(win_rec)
            self.merged_events += merged
            for k, v in stats.items():
                self.align_stats[k] = self.align_stats.get(k, 0) + v
            ref = self._last_cycle_t if self._last_cycle_t is not None else self._started_t
            elapsed = max(now - (ref or now), self._active_s, 1e-9)
            self._last_cycle_t = now
            overhead = self.budget.observe(cost_s, elapsed)
            _, off_s = self.budget.plan()
            self._next_open_t = now + off_s
            if self.degraded is None and self.failed is None:
                self.collector.record("mark", "device_window", {
                    **win_rec, "overhead_pct": round(overhead, 4),
                })
            self._export_gauges(now)
            return merged

    def _pause(self) -> None:
        """Before a CUDA graph capture (:func:`capture_guard`)."""
        with self._lock:
            self._capturing += 1
            if self._session_open:
                try:
                    self._stop_session()
                except Exception as exc:
                    self._degrade(f"{type(exc).__name__}: {exc}")

    def _unpause(self) -> None:
        with self._lock:
            self._capturing -= 1

    def boundary(self) -> None:
        """At a step boundary on the serving / training thread: resume a
        window paused by a capture, close one whose on-time has passed, or
        open the next one once the off time has passed."""
        with self._lock:
            if self.degraded or self.failed or self._capturing:
                return
            now = time.monotonic()
            if self._window_open:
                if not self._session_open:
                    self._start_session()
                elif self._active_s + now - self._session_t0 >= self._on_s:
                    self.close_window()
            elif now >= self._next_open_t:
                self.open_window()

    def _on_event(self, e: Any) -> None:
        if e.kind != "exit" or e.name not in BOUNDARIES or self._in_boundary:
            return
        self._in_boundary = True  # a close records events: no re-entry
        try:
            self.boundary()
        except Exception as exc:  # a sink error would detach the sink silently
            self._degrade(f"{type(exc).__name__}: {exc}")
        finally:
            self._in_boundary = False

    def _export_gauges(self, now: float) -> None:
        if self._g_coverage is not None and self._started_t is not None:
            run_s = max(now - self._started_t, 1e-9)
            cov = min(1.0, sum(w["on_s"] for w in self.windows) / run_s)
            self._g_coverage.set(round(cov, 4))
        if self._g_quality is not None:
            total = self.align_stats.get("total", 0)
            if total:
                self._g_quality.set(round(self.align_stats.get("span", 0) / total, 4))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LiveDeviceProfiler":
        warm = getattr(self.backend, "warm", None)
        if warm is not None:
            t0 = time.perf_counter()
            warm()
            self.init_s = time.perf_counter() - t0
        set_annotations(True)
        self._started_t = time.monotonic()
        self._next_open_t = self._started_t
        self.collector.record("mark", "device_window", {
            "phase": "start",
            "backend": getattr(self.backend, "name", self.backend_kind),
            "budget_pct": self.budget.budget_pct,
            "period_s": self.budget.period_s,
            "out_dir": self.out_dir,
        })
        # untimed: a window's close is charged by the device budget, not by
        # the record path of the exit that set it off
        self.collector.add_sink(self._on_event, sampled=False, timed=False)
        _ACTIVE.add(self)
        return self

    def stop(self) -> None:
        _ACTIVE.discard(self)
        self.collector.remove_sink(self._on_event)
        if self._window_open:
            self.close_window()  # short runs still merge their one window
        set_annotations(False)
        self._export_gauges(time.monotonic())
        self.budget.export()
        if self.failed is not None:
            raise RuntimeError(f"device capture failed: {self.failed}")
        seen = [w for w in self.windows if w.get("empty") != "empty"]
        if self.strict and seen and all(w.get("empty") == "no_device_rows" for w in seen):
            raise RuntimeError(
                f"device capture failed: all {len(seen)} windows with launches came back "
                "without device rows")

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Coverage + alignment summary; the stream's ``device_provider``."""
        with self._lock:
            now = time.monotonic()
            run_s = (now - self._started_t) if self._started_t else 0.0
            on_s = sum(w["on_s"] for w in self.windows)
            total = self.align_stats.get("total", 0)
            return {
                "backend": getattr(self.backend, "name", self.backend_kind),
                "out_dir": self.out_dir,
                "degraded": self.degraded,
                "failed": self.failed,
                "windows": len(self.windows),
                "init_s": round(self.init_s, 6),
                "no_device_rows": self.no_device_rows,
                "empty_windows": self.empty_windows,
                "merged_events": self.merged_events,
                "align": {
                    **self.align_stats,
                    "annotated_fraction": (
                        self.align_stats.get("span", 0) / total if total else 0.0),
                },
                "coverage": {
                    "captured_s": round(on_s, 6),
                    "run_s": round(run_s, 6),
                    "fraction": round(min(1.0, on_s / run_s), 4) if run_s > 0 else 0.0,
                },
                "budget": self.budget.snapshot(),
                "window_log": self.windows[-64:],
            }
