"""Trace→metrics bridge: a collector sink that folds events into a registry
(counterpart of ``repro/metrics/sink.py``).

``MetricsSink`` is a plain ``fn(event)`` callable, installed on a
:class:`~repro_torch.trace.collector.TraceCollector` through the **unsampled** sink
slot (``add_sink(sink, sampled=False)``): it sees every recorded event even
while the adaptive controller is shedding span *capture*, so counters and
latency histograms stay exact under duty-cycling — sampling bounds what is
stored and streamed, never what is counted.

Derived series (all prefixed ``repro_``):

* per-unit counters+histograms from spawn/exit pairs — ``repro_requests_total``
  / ``repro_request_ms`` and the same for step, microbatch, prefill,
  decode_tick, checkpoint, restart, train_step;
* ``repro_dispatch_total{op,backend,source}`` and
  ``repro_dispatch_ms{op,backend}`` from dispatch decisions' measured runs;
* ``repro_device_ms{device,op}`` histograms and
  ``repro_device_slices_total{align}`` from merged device slices, plus
  ``repro_device_capture_windows_total`` from the live profiler's
  window-close marks (see :mod:`repro_torch.trace.liveprof`);
* ``repro_router_requests_total{replica,outcome}`` and
  ``repro_router_route_ms`` from the router front door's terminal ``route``
  outcome events (see :mod:`repro_torch.router.frontdoor`);
* ``repro_tune_points_total{op,pruned}`` from design-space sweep points and
  ``repro_tune_best_speedup{op}`` gauges from per-space winner events (see
  :mod:`repro_torch.tune.explore`);
* ``repro_stragglers_total``, ``repro_trace_controller_events_total``;
* ``repro_trace_events_total{kind}`` for the raw stream.

``MetricsPlane`` bundles a registry + sink + the collector's cheap drop
counters into the one object drivers hand to the HTTP listener and the
streaming session's per-rotation snapshot hook.
"""
from __future__ import annotations

import functools
import re
import threading
from typing import Any, Optional

from repro_torch.core.events import Event
from repro_torch.metrics.registry import Counter, Histogram, MetricsRegistry

# Unit-lifecycle names worth a dedicated duration histogram; everything else
# still lands in the kind-labelled event counter.
TIMED_UNITS = frozenset({
    "request", "prefill", "decode_tick", "step", "train_step", "microbatch",
    "checkpoint", "restart", "serve_run", "train_run",
})

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
# "span=<id>" annotation prefixes on device slice names are per-request —
# strip them so the op label stays low-cardinality
_SPAN_TOKEN_RE = re.compile(r"\bspan[=:]\d+\s*")


def _metric_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


@functools.lru_cache(maxsize=4096)  # kernel names repeat by the thousand a window
def _device_op(name: str) -> str:
    return _SPAN_TOKEN_RE.sub("", name).strip() or "?"


class MetricsSink:
    """Callable event sink updating a :class:`MetricsRegistry` in-place."""

    def __init__(self, registry: MetricsRegistry, *, max_open_spans: int = 8192) -> None:
        self.registry = registry
        self._max_open = max_open_spans
        self._open: dict[int, float] = {}  # span id -> spawn wall-time
        self._lock = threading.Lock()
        self._kind_counters: dict[str, Counter] = {}
        self._unit_counters: dict[str, Counter] = {}
        self._unit_hists: dict[str, Histogram] = {}
        self._dispatch_counters: dict[tuple, Counter] = {}
        self._dispatch_hists: dict[tuple, Histogram] = {}
        self._device_hists: dict[tuple, Histogram] = {}
        self._device_counters: dict[str, Counter] = {}
        self._router_counters: dict[tuple, Counter] = {}
        self._tune_counters: dict[tuple, Counter] = {}
        self._route_hist: Optional[Histogram] = None
        self._hop_hists: dict[str, Histogram] = {}
        self._hop_mismatch: Optional[Counter] = None
        self._capture_windows = registry.counter(
            "repro_device_capture_windows_total",
            "live device-capture windows merged")
        self._stragglers = registry.counter(
            "repro_stragglers_total", "straggler detections")
        self._controller_events = registry.counter(
            "repro_trace_controller_events_total",
            "adaptive controller decisions recorded into the trace")

    def _kind_counter(self, kind: str) -> Counter:
        c = self._kind_counters.get(kind)
        if c is None:
            c = self.registry.counter("repro_trace_events_total",
                                      "events seen by the metrics sink", kind=kind)
            self._kind_counters[kind] = c
        return c

    def _unit(self, name: str) -> tuple[Counter, Optional[Histogram]]:
        c = self._unit_counters.get(name)
        if c is None:
            m = _metric_name(name)
            c = self.registry.counter(f"repro_{m}s_total", f"completed {name} units")
            self._unit_counters[name] = c
            if name in TIMED_UNITS:
                self._unit_hists[name] = self.registry.histogram(
                    f"repro_{m}_ms", f"{name} wall time (ms)")
        return c, self._unit_hists.get(name)

    def __call__(self, e: Event) -> None:
        self._kind_counter(e.kind).inc()
        if e.kind == "spawn":
            if e.span:
                with self._lock:
                    if len(self._open) >= self._max_open:
                        self._open.pop(next(iter(self._open)))
                    self._open[e.span] = e.t
        elif e.kind == "exit":
            counter, hist = self._unit(e.name)
            counter.inc()
            if e.span and hist is not None:
                with self._lock:
                    t0 = self._open.pop(e.span, None)
                if t0 is not None:
                    hist.observe((e.t - t0) * 1e3)
        elif e.kind == "dispatch":
            p = e.payload if isinstance(e.payload, dict) else {}
            key = (e.name, str(p.get("backend")), str(p.get("source")))
            c = self._dispatch_counters.get(key)
            if c is None:
                c = self.registry.counter(
                    "repro_dispatch_total", "dispatch decisions",
                    op=key[0], backend=key[1], source=key[2])
                self._dispatch_counters[key] = c
            c.inc()
            measured = p.get("measured_s")
            if isinstance(measured, (int, float)):
                hkey = (e.name, key[1])
                h = self._dispatch_hists.get(hkey)
                if h is None:
                    h = self.registry.histogram(
                        "repro_dispatch_ms", "measured dispatch execution (ms)",
                        op=hkey[0], backend=hkey[1])
                    self._dispatch_hists[hkey] = h
                h.observe(float(measured) * 1e3)
        elif e.kind == "device":
            p = e.payload if isinstance(e.payload, dict) else {}
            align = str(p.get("align") or "none")
            c = self._device_counters.get(align)
            if c is None:
                c = self.registry.counter(
                    "repro_device_slices_total",
                    "merged device slices by alignment mode", align=align)
                self._device_counters[align] = c
            c.inc()
            dur = p.get("dur_s")
            if isinstance(dur, (int, float)):
                hkey = (str(p.get("device") or "?"), _device_op(e.name))
                h = self._device_hists.get(hkey)
                if h is None:
                    h = self.registry.histogram(
                        "repro_device_ms", "device slice wall time (ms)",
                        device=hkey[0], op=hkey[1])
                    self._device_hists[hkey] = h
                h.observe(float(dur) * 1e3)
        elif e.kind == "route":
            # only the terminal per-request outcome counts a request; the
            # per-attempt "route" decision events would overcount retries
            if e.name != "outcome":
                return
            p = e.payload if isinstance(e.payload, dict) else {}
            key = (str(p.get("replica")), str(p.get("outcome")))
            c = self._router_counters.get(key)
            if c is None:
                c = self.registry.counter(
                    "repro_router_requests_total",
                    "routed requests by terminal outcome",
                    replica=key[0], outcome=key[1])
                self._router_counters[key] = c
            c.inc()
            route_ms = p.get("route_ms")
            if isinstance(route_ms, (int, float)):
                if self._route_hist is None:
                    self._route_hist = self.registry.histogram(
                        "repro_router_route_ms",
                        "routing-decision overhead per request (ms)")
                self._route_hist.observe(float(route_ms))
            hops = p.get("hops")
            if isinstance(hops, dict):
                # per-hop latency decomposition (frontdoor_queue | network |
                # replica_queue | service); the four telescope to the
                # end-to-end latency, so a sum drifting past 5% of latency_ms
                # means a hop was measured wrong — count it, don't hide it
                total = 0.0
                for hop in ("frontdoor_queue", "network", "replica_queue",
                            "service"):
                    v = hops.get(hop)
                    if not isinstance(v, (int, float)):
                        continue
                    total += float(v)
                    h = self._hop_hists.get(hop)
                    if h is None:
                        h = self.registry.histogram(
                            "repro_router_hop_ms",
                            "per-hop request latency decomposition (ms)",
                            hop=hop)
                        self._hop_hists[hop] = h
                    h.observe(max(0.0, float(v)))
                lat = p.get("latency_ms")
                if (isinstance(lat, (int, float)) and lat > 0
                        and abs(total - float(lat)) > 0.05 * float(lat)):
                    if self._hop_mismatch is None:
                        self._hop_mismatch = self.registry.counter(
                            "repro_router_hop_sum_mismatch_total",
                            "requests whose hop decomposition failed to sum "
                            "to end-to-end latency (within 5%)")
                    self._hop_mismatch.inc()
        elif e.kind == "tune":
            p = e.payload if isinstance(e.payload, dict) else {}
            if p.get("winner"):
                # best-vs-default per op; >= 1.0 by construction (the default
                # point competes in the same argmin)
                speedup = p.get("speedup")
                if isinstance(speedup, (int, float)):
                    self.registry.gauge(
                        "repro_tune_best_speedup",
                        "tuned best-config speedup over the hand-picked default",
                        op=str(p.get("op"))).set(float(speedup))
                return
            key = (str(p.get("op")), "true" if p.get("pruned") else "false")
            c = self._tune_counters.get(key)
            if c is None:
                c = self.registry.counter(
                    "repro_tune_points_total",
                    "design-space points seen by the tuner",
                    op=key[0], pruned=key[1])
                self._tune_counters[key] = c
            c.inc()
        elif e.name == "device_window":
            p = e.payload if isinstance(e.payload, dict) else {}
            if "events" in p:  # window-close marks only (not start/warning)
                self._capture_windows.inc()
        elif e.kind == "straggler":
            self._stragglers.inc()
        elif e.name == "controller":
            self._controller_events.inc()


class MetricsPlane:
    """Registry + sink + collector drop/sampling gauges, as one attachable unit."""

    def __init__(self, collector: Any = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        self.sink = MetricsSink(self.registry)
        self.collector: Any = None
        if collector is not None:
            self.attach(collector)

    def attach(self, collector: Any) -> "MetricsPlane":
        """Fan the sink in as an *unsampled* sink: metrics see shed events."""
        add_sink = getattr(collector, "add_sink", None)
        if add_sink is None:
            raise TypeError(
                f"{type(collector).__name__} has no add_sink fan-out; "
                "MetricsPlane requires a TraceCollector")
        add_sink(self.sink, sampled=False)
        self.collector = collector
        return self

    def refresh(self) -> None:
        """Pull the collector's cheap drop/sampling counters into gauges."""
        c = self.collector
        drop_counters = getattr(c, "drop_counters", None)
        if drop_counters is None:
            return
        d = drop_counters()
        g = self.registry.gauge
        g("repro_trace_dropped_total", "events evicted from bounded rings").set(
            d.get("dropped", 0))
        g("repro_trace_sampled_out_total",
          "events shed by the adaptive controller").set(d.get("sampled_out", 0))
        for track, n in (d.get("by_track") or {}).items():
            if n:
                g("repro_trace_dropped_by_track", "ring evictions per track",
                  track=track or "main").set(n)
        g("repro_trace_sample_rate", "current capture duty cycle [0,1]").set(
            getattr(c, "sample_rate", 1.0))

    def snapshot(self) -> dict[str, Any]:
        self.refresh()
        return self.registry.snapshot()

    def render(self) -> str:
        self.refresh()
        return self.registry.render()

    def summary(self) -> dict[str, float]:
        """Flat {series: value} of all counters/gauges (histograms as _count)."""
        self.refresh()
        out: dict[str, float] = {}
        for m in self.registry.metrics():
            labels = "".join(
                f",{k}={v}" for k, v in sorted(m.labels.items()))
            if m.kind == "histogram":
                out[f"{m.name}_count{{{labels.lstrip(',')}}}" if labels
                    else f"{m.name}_count"] = m.count
            else:
                out[f"{m.name}{{{labels.lstrip(',')}}}" if labels
                    else m.name] = m.value
        return out
