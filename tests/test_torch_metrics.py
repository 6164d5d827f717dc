"""The port's metrics plane (``repro_torch.metrics``) against the JAX package's.

The Prometheus text of the same series is the same bytes; the trace sink
turns the same scripted events into the same series; the adaptive
controller and the device-capture budget follow the same law on injected
readings; the scrape listener serves ``/metrics``, ``/metrics.json`` and
``/healthz``.
"""
import json
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from repro.core.events import Event as JaxEvent  # noqa: E402
from repro.metrics import AdaptiveController as JaxAdaptiveController  # noqa: E402
from repro.metrics import DeviceCaptureBudget as JaxDeviceCaptureBudget  # noqa: E402
from repro.metrics import MetricsPlane as JaxMetricsPlane  # noqa: E402
from repro.metrics import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from repro.metrics import MetricsSink as JaxMetricsSink  # noqa: E402
from repro.metrics import DEFAULT_BUCKETS_MS as JAX_BUCKETS_MS  # noqa: E402
from repro.trace.collector import TraceCollector as JaxTraceCollector  # noqa: E402
from repro_torch.core.events import Event  # noqa: E402
from repro_torch.core.overhead import stats_from_samples  # noqa: E402
from repro_torch.metrics import (DEFAULT_BUCKETS_MS, DEFAULT_BUDGET_PCT, TIMED_UNITS,  # noqa: E402
                                 AdaptiveController, DeviceCaptureBudget, MetricsPlane,
                                 MetricsRegistry, MetricsSink, calibrate_noop, serve_metrics)
from repro_torch.trace.collector import TraceCollector  # noqa: E402


def fill(reg) -> None:
    """The same series, labels and samples in a registry of either package."""
    reg.counter("repro_requests_total", "completed requests").inc(7)
    reg.counter("repro_dispatch_total", "decisions", op="serve_decode", backend="kernel").inc(3)
    reg.counter("repro_dispatch_total", "decisions", op="serve_decode", backend="plain").inc()
    g = reg.gauge("repro_serve_queue_depth", "waiting requests")
    g.set(4)
    g.set(2.5)
    h = reg.histogram("repro_decode_tick_ms", "tick wall ms")
    for v in (0.3, 3.99, 4.1, 17.0, 250.0, 1e6):
        h.observe(v)
    reg.histogram("repro_device_ms", "device ms", device="cuda:0", op="flash_fwd_mma<64>").observe(
        0.018)


def test_prometheus_text_and_snapshot_match_jax():
    ours, theirs = MetricsRegistry(), JaxMetricsRegistry()
    fill(ours)
    fill(theirs)
    assert ours.render() == theirs.render()
    a, b = ours.snapshot(), theirs.snapshot()
    assert [m for m in a["metrics"]] == [m for m in b["metrics"]]
    assert "repro_decode_tick_ms_bucket" in ours.render()
    assert tuple(DEFAULT_BUCKETS_MS) == tuple(JAX_BUCKETS_MS)


def events(cls):
    """A run's worth of events (``cls`` is either package's Event)."""
    out = [cls(1.0, "spawn", "serve_run", None, 1, 0)]
    for i in range(4):
        out += [cls(1.0 + i, "spawn", "request", i, 10 + i, 1),
                cls(1.1 + i, "spawn", "prefill", i, 20 + i, 10 + i),
                cls(1.15 + i, "dispatch", "serve_prefill",
                    {"op": "serve_prefill", "backend": "kernel", "source": "measured",
                     "measured_s": 0.005}, 30 + i, 20 + i),
                cls(1.2 + i, "exit", "prefill", i, 20 + i, 10 + i),
                cls(1.21 + i, "device", f"span={20 + i} flash_fwd_mma<64>",
                    {"dur_s": 2e-5, "device": "cuda:0", "align": "span"}, 40 + i, 20 + i),
                cls(1.3 + i, "exit", "request", i, 10 + i, 1)]
    out += [cls(9.0, "straggler", "step", {"s": 1.0}, 0, 1),
            cls(9.1, "mark", "controller", {"rate": 0.5}, 0, 0),
            cls(9.2, "mark", "device_window", {"events": 4, "on_s": 0.1}, 0, 0),
            cls(9.3, "exit", "serve_run", None, 1, 0)]
    return out


def test_sink_series_match_jax():
    ours, theirs = MetricsRegistry(), JaxMetricsRegistry()
    sink, jsink = MetricsSink(ours), JaxMetricsSink(theirs)
    for e in events(Event):
        sink(e)
    for e in events(JaxEvent):
        jsink(e)
    assert ours.render() == theirs.render()
    text = ours.render()
    for series in ("repro_requests_total 4", "repro_prefill_ms_count 4",
                   'repro_device_slices_total{align="span"} 4',
                   "repro_device_capture_windows_total 1", "repro_stragglers_total 1"):
        assert series in text, series
    assert TIMED_UNITS >= {"request", "prefill", "decode_tick", "step"}


def test_plane_on_collectors_matches_jax():
    """The plane attached to both packages' collectors, a sampled-out flood
    and a small ring: the same summary and the same drop gauges."""
    ours = MetricsPlane(TraceCollector(8))
    theirs = JaxMetricsPlane(JaxTraceCollector(8))
    for plane in (ours, theirs):
        plane.collector.set_sample_rate(0.5)
        for i in range(20):
            plane.collector.record("spawn", "request", i, span=100 + i, parent=0, t=float(i))
            plane.collector.record("exit", "request", i, span=100 + i, parent=0, t=i + 0.5)
    assert ours.summary() == theirs.summary()
    assert ours.render() == theirs.render()
    assert ours.summary()["repro_requests_total"] == 20  # counted though shed


class FakeCollector:
    """Injected record-path readings for the controller."""

    def __init__(self, readings):
        self.readings = list(readings)
        self.rates: list = []
        self.marks: list = []

    def timing_snapshot(self):
        return self.readings.pop(0)

    def set_sample_rate(self, r):
        self.rates.append(round(r, 9))

    def record(self, kind, name, payload=None, **kw):
        self.marks.append((kind, name, payload))


def test_controller_law_matches_jax(monkeypatch):
    clock = iter(range(1000))
    monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)) * 0.25)
    readings = [{"timed": 100, "timed_s": 100 * s, "records": 100 * n}
                for s, n in ((2e-5, 50), (4e-5, 200), (1e-6, 10), (1e-5, 100), (0.0, 0),
                             (3e-5, 500), (1e-7, 1), (1e-7, 1), (1e-7, 1))]
    noop = stats_from_samples("noop", [0.0005] * 8)
    out = []
    for cls in (AdaptiveController, JaxAdaptiveController):
        fake = FakeCollector(readings)
        ctl = cls(fake, None, budget_pct=DEFAULT_BUDGET_PCT, noop=noop)
        seq = [(round(ctl.step(), 9), round(ctl.rate, 9)) for _ in readings]
        out.append((seq, fake.rates, fake.marks, ctl.snapshot()))
    assert out[0] == out[1]
    assert out[0][0][1][1] < 1.0  # the law backed off over budget
    always_on = AdaptiveController(FakeCollector(readings), budget_pct=0.0, noop=noop)
    for _ in readings:
        always_on.step()
    assert always_on.rate == 1.0 and always_on.adjustments == 0


def test_device_budget_law_matches_jax():
    feed = [(0.8, 1.0), (0.8, 17.0), (0.05, 20.0), (0.01, 5.0), (0.01, 5.0), (0.3, 2.0)]
    out = []
    for cls in (DeviceCaptureBudget, JaxDeviceCaptureBudget):
        for pct in (5.0, 0.0):
            b = cls(None, budget_pct=pct, period_s=0.2)
            seq = [b.plan()]
            for cost, elapsed in feed:
                seq.append((round(b.observe(cost, elapsed), 9), b.plan()))
            out.append((seq, b.snapshot()))
    assert out[:2] == out[2:]
    assert out[1][1]["capture_enabled"] is False  # budget 0: one calibration window


def test_calibrate_noop_times_a_call():
    noop = calibrate_noop(runs=32, warmup=8)
    assert noop.label == "noop" and 0 < noop.mean_ms < 1.0


def test_http_listener_serves_the_plane():
    plane = MetricsPlane(TraceCollector())
    plane.collector.record("spawn", "request", 0, span=5, parent=0)
    plane.collector.record("exit", "request", 0, span=5, parent=0)
    server = serve_metrics(plane, port=0)
    try:
        with urllib.request.urlopen(server.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "repro_requests_total 1" in text and "repro_trace_dropped_total" in text
        with urllib.request.urlopen(server.url + "/metrics.json", timeout=10) as r:
            assert any(m["name"] == "repro_requests_total" for m in json.load(r)["metrics"])
        with urllib.request.urlopen(server.url + "/healthz", timeout=10) as r:
            assert json.load(r)["ok"] is True
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url + "/nope", timeout=10)
    finally:
        server.stop()
