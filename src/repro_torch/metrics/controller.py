"""Adaptive sampling controller: tracing overhead as a closed feedback loop
(counterpart of ``repro/metrics/controller.py``; the same control law).

The paper answers "is instrumentation cheap enough to leave on?" once, in
Table I, with an offline hyperfine run.  This controller answers it
continuously: it calibrates a no-op baseline with the same
:class:`~repro_torch.core.overhead.TimingStats` protocol, then periodically reads
the collector's record-path self-timing (``timing_snapshot()``: every Nth
``record()`` call is wall-clocked end-to-end, sinks included), converts it
into *percent of wall time spent tracing* and duty-cycles span capture
(``set_sample_rate``) to hold that number under ``budget_pct``.

Control law: proportional back-off when over budget
(``rate *= budget/overhead``, floored at ``min_rate``), multiplicative
recovery toward 1.0 once overhead falls below half the budget.  Every rate
change is itself recorded as a ``controller`` event — the decision trail
rides in the trace, on an essential track the controller never sheds.

``budget_pct <= 0`` means **always-on**: the controller keeps measuring and
exporting the overhead gauge but never reduces the rate — the configuration
the benchmarks use to show the bound is real.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

from typing import TYPE_CHECKING

from repro_torch.metrics.registry import MetricsRegistry

if TYPE_CHECKING:
    from repro_torch.core.overhead import TimingStats

DEFAULT_BUDGET_PCT = 5.0  # the paper's Table I ballpark (+5.1% / +4.8%)


def calibrate_noop(runs: int = 256, warmup: int = 64) -> "TimingStats":
    """Cost of a timed call that records nothing — the overhead zero point,
    measured by :func:`repro_torch.core.overhead.hyperfine` (imported here:
    it pulls in the model configs, which only a run that *starts* the
    adaptive controller needs)."""
    from repro_torch.core.overhead import hyperfine

    return hyperfine(lambda: None, label="noop", warmup=warmup, runs=runs)


class AdaptiveController:
    """Bounds measured tracing overhead by duty-cycling span capture."""

    def __init__(
        self,
        collector: Any,
        registry: Optional[MetricsRegistry] = None,
        *,
        budget_pct: float = DEFAULT_BUDGET_PCT,
        interval_s: float = 0.25,
        min_rate: float = 0.05,
        grow: float = 1.5,
        smooth: float = 0.5,
        calibration_runs: int = 256,
        noop: Optional[TimingStats] = None,
    ) -> None:
        self.collector = collector
        self.budget_pct = float(budget_pct)
        self.interval_s = interval_s
        self.min_rate = min_rate
        self.grow = grow
        self.smooth = smooth
        self.noop = noop if noop is not None else calibrate_noop(calibration_runs)
        self._noop_s = self.noop.mean_ms * 1e-3
        self.rate = 1.0
        self.overhead_pct = 0.0
        self.adjustments = 0
        self._last_t = time.monotonic()
        self._pending = {"timed": 0, "timed_s": 0.0, "records": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_overhead = self._g_rate = self._g_adjust = None
        if registry is not None:
            self._g_overhead = registry.gauge(
                "repro_trace_overhead_pct",
                "self-measured record-path overhead, % of wall time (EWMA)")
            self._g_rate = registry.gauge(
                "repro_trace_sample_rate_target",
                "controller-chosen capture duty cycle")
            self._g_budget = registry.gauge(
                "repro_trace_overhead_budget_pct", "configured overhead budget")
            self._g_budget.set(self.budget_pct)
            self._g_adjust = registry.gauge(
                "repro_trace_controller_adjustments", "rate changes so far")
            self._g_rate.set(self.rate)
        if hasattr(collector, "set_sample_rate"):
            collector.set_sample_rate(self.rate)

    # -- control loop --------------------------------------------------------

    def step(self) -> float:
        """One control tick; returns the current overhead estimate (pct).

        Public and deterministic (no sleeping) so tests and benchmarks can
        drive the loop themselves.  Windows shorter than half the control
        interval bank their timing snapshot and keep the previous estimate:
        a near-empty window that catches one expensive record (the final
        rotation fsync at shutdown, say) would otherwise spike the EWMA
        right before drivers report the end-state gauge.
        """
        now = time.monotonic()
        elapsed = now - self._last_t
        snap = self.collector.timing_snapshot()
        self._pending["timed"] += snap["timed"]
        self._pending["timed_s"] += snap["timed_s"]
        self._pending["records"] += snap["records"]
        if elapsed < 0.5 * self.interval_s:
            return self.overhead_pct
        self._last_t = now
        pend, self._pending = self._pending, {
            "timed": 0, "timed_s": 0.0, "records": 0}
        if elapsed > 0 and pend["timed"] > 0 and pend["records"] > 0:
            per_record_s = pend["timed_s"] / pend["timed"]
            inst = 100.0 * max(0.0, per_record_s - self._noop_s) \
                * pend["records"] / elapsed
            self.overhead_pct = (self.smooth * inst
                                 + (1.0 - self.smooth) * self.overhead_pct)
            if self.budget_pct > 0:
                self._adjust()
        if self._g_overhead is not None:
            self._g_overhead.set(round(self.overhead_pct, 4))
            self._g_rate.set(self.rate)
            self._g_adjust.set(self.adjustments)
        return self.overhead_pct

    def _adjust(self) -> None:
        rate = self.rate
        if self.overhead_pct > self.budget_pct:
            rate = max(self.min_rate,
                       rate * self.budget_pct / self.overhead_pct)
        elif self.overhead_pct < 0.5 * self.budget_pct and rate < 1.0:
            rate = min(1.0, rate * self.grow)
        if abs(rate - self.rate) < 1e-3:
            return
        prev, self.rate = self.rate, rate
        self.adjustments += 1
        if hasattr(self.collector, "set_sample_rate"):
            self.collector.set_sample_rate(rate)
        self.collector.record("mark", "controller", {
            "rate": round(rate, 4),
            "prev": round(prev, 4),
            "overhead_pct": round(self.overhead_pct, 4),
            "budget_pct": self.budget_pct,
        })

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AdaptiveController":
        if self._thread is not None:
            return self
        self.collector.record("mark", "controller", {
            "rate": self.rate,
            "budget_pct": self.budget_pct,
            "noop_ms": round(self.noop.mean_ms, 6),
            "interval_s": self.interval_s,
        })
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="repro-trace-controller", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # a torn snapshot must not kill the loop
                pass

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.step()  # final reading so drivers report the end-state gauge

    def snapshot(self) -> dict[str, Any]:
        return {
            "budget_pct": self.budget_pct,
            "overhead_pct": round(self.overhead_pct, 4),
            "sample_rate": round(self.rate, 4),
            "adjustments": self.adjustments,
            "noop_ms": round(self.noop.mean_ms, 6),
        }


class DeviceCaptureBudget:
    """Second budget loop, device-specific: schedules duty-cycled profiler
    capture windows for :class:`repro_torch.trace.liveprof.LiveDeviceProfiler`.

    Host-span shedding (:class:`AdaptiveController`) bounds a *per-event*
    cost by admitting fewer events.  Device capture has a different cost
    shape: each window pays a largely **fixed** price (profiler start/stop
    plus parsing and aligning the dump) regardless of how short the window
    is, so shrinking the window-on fraction alone cannot bound overhead —
    the off time between windows must stretch until the fixed cost
    amortises under budget.  The law here does both:

    * overhead EWMA from each cycle's measured cost over its wall time;
    * over budget → shrink ``on_fraction`` proportionally (less device data
      per cycle, cheaper parse) **and** lengthen the next off time to
      ``cost * 100/budget`` so even the fixed floor fits the budget;
    * under half budget → multiplicative recovery of ``on_fraction``.

    ``budget_pct <= 0`` means **measure-only**: one calibration window runs
    (so the cost gauges mean something), then capture disables and the loop
    keeps exporting the measured numbers.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        budget_pct: float = DEFAULT_BUDGET_PCT,
        period_s: float = 2.0,
        min_on_s: float = 0.05,
        min_fraction: float = 0.05,
        grow: float = 1.5,
        smooth: float = 0.5,
    ) -> None:
        self.budget_pct = float(budget_pct)
        self.period_s = float(period_s)
        self.min_on_s = min_on_s
        self.min_fraction = min_fraction
        self.grow = grow
        self.smooth = smooth
        self.on_fraction = 0.5 if self.budget_pct > 0 else min_fraction
        self.overhead_pct = 0.0
        self.cost_ewma_s = 0.0
        self.windows = 0
        self.adjustments = 0
        self.capture_enabled = True
        self._g_overhead = self._g_fraction = self._g_budget = None
        self._g_adjust = self._g_windows = None
        if registry is not None:
            self._g_overhead = registry.gauge(
                "repro_device_capture_overhead_pct",
                "measured device-capture overhead (start/stop+parse+align),"
                " % of wall time (EWMA)")
            self._g_fraction = registry.gauge(
                "repro_device_capture_on_fraction",
                "fraction of each capture period the profiler window is on")
            self._g_budget = registry.gauge(
                "repro_device_capture_budget_pct",
                "configured device-capture overhead budget")
            self._g_budget.set(self.budget_pct)
            self._g_adjust = registry.gauge(
                "repro_device_capture_adjustments",
                "device window-fraction changes so far")
            self._g_windows = registry.gauge(
                "repro_device_capture_windows",
                "device capture windows completed so far")
            self._g_fraction.set(self.on_fraction)

    def plan(self) -> tuple[float, float]:
        """(on_s, off_s) for the next capture cycle.

        ``on_s = 0`` means capture is disabled (measure-only after the
        calibration window, or the budget loop shut it off)."""
        if not self.capture_enabled:
            return 0.0, self.period_s
        on_s = max(self.min_on_s, self.period_s * self.on_fraction)
        off_s = self.period_s - on_s
        if self.budget_pct > 0 and self.cost_ewma_s > 0:
            # the fixed per-window cost must amortise under budget even if
            # narrowing the window saves nothing: stretch the off time
            need = self.cost_ewma_s * 100.0 / self.budget_pct - on_s
            off_s = max(off_s, need)
        return on_s, max(0.0, off_s)

    def observe(self, cost_s: float, elapsed_s: float) -> float:
        """Fold one completed window's measured cost into the loop.

        ``cost_s`` is the wall time the capture machinery itself consumed
        (start+stop+parse+align); ``elapsed_s`` the full cycle it is spread
        over.  Returns the overhead estimate (pct)."""
        self.windows += 1
        self.cost_ewma_s = (cost_s if self.windows == 1 else
                            self.smooth * cost_s
                            + (1.0 - self.smooth) * self.cost_ewma_s)
        if elapsed_s > 0:
            inst = 100.0 * cost_s / elapsed_s
            self.overhead_pct = (inst if self.windows == 1 else
                                 self.smooth * inst
                                 + (1.0 - self.smooth) * self.overhead_pct)
        if self.budget_pct <= 0:
            # calibration complete: measure-only from here on
            self.capture_enabled = False
        else:
            f = self.on_fraction
            if self.overhead_pct > self.budget_pct:
                f = max(self.min_fraction,
                        f * self.budget_pct / self.overhead_pct)
            elif self.overhead_pct < 0.5 * self.budget_pct and f < 1.0:
                f = min(1.0, f * self.grow)
            if abs(f - self.on_fraction) >= 1e-3:
                self.on_fraction = f
                self.adjustments += 1
        self.export()
        return self.overhead_pct

    def export(self) -> None:
        if self._g_overhead is None:
            return
        self._g_overhead.set(round(self.overhead_pct, 4))
        self._g_fraction.set(round(self.on_fraction if self.capture_enabled
                                   else 0.0, 4))
        self._g_adjust.set(self.adjustments)
        self._g_windows.set(self.windows)

    def snapshot(self) -> dict[str, Any]:
        return {
            "budget_pct": self.budget_pct,
            "overhead_pct": round(self.overhead_pct, 4),
            "on_fraction": round(self.on_fraction, 4),
            "cost_ewma_s": round(self.cost_ewma_s, 6),
            "windows": self.windows,
            "adjustments": self.adjustments,
            "capture_enabled": self.capture_enabled,
        }
