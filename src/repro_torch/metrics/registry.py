"""Metric primitives: counters, gauges and fixed-bucket histograms
(counterpart of ``repro/metrics/registry.py``; the same Prometheus text).

The live complement to ``repro_torch.trace``'s event stream: where a trace answers
"what happened, in order", a metric answers "how much, right now" — cheap
enough to update on every recorded event and small enough to scrape, merge
and snapshot without ever storing samples.

* :class:`Counter` / :class:`Gauge` — a locked float; counters only go up.
* :class:`Histogram` — fixed exponential bucket bounds (milliseconds by
  default).  Observations land in buckets by binary search; quantiles are
  answered by walking the cumulative counts and linearly interpolating
  inside the target bucket, clamped to the observed min/max.  Two
  histograms with identical bounds **merge** by adding bucket counts, which
  is associative and commutative — per-rotation snapshots, per-host shards
  and fleet-level rollups all compose from the same operation.
* :class:`MetricsRegistry` — get-or-create keyed by ``(name, labels)``,
  JSON-able :meth:`~MetricsRegistry.snapshot` and Prometheus text-format
  :meth:`~MetricsRegistry.render` (the ``/metrics`` wire format).
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Mapping, Optional, Sequence

# Exponential-ish bounds in milliseconds: microsecond record-path costs up to
# multi-second checkpoint restores land with < one-bucket quantile error.
DEFAULT_BUCKETS_MS: tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def _label_key(labels: Mapping[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Mapping[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter. ``inc`` only accepts non-negative deltas."""

    kind = "counter"

    def __init__(self, name: str, labels: Mapping[str, str], help: str = "") -> None:
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "labels": self.labels,
                "value": self.value}

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} {_fmt_value(self.value)}"]


class Gauge(Counter):
    """A value that can go either way (depth, rate, last-seen overhead %)."""

    kind = "gauge"

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)


class Histogram:
    """Fixed-bound histogram with interpolated quantiles and exact merge.

    ``bounds`` are the upper edges of the finite buckets (strictly
    increasing); one implicit overflow bucket catches everything above the
    last bound.  ``quantile(q)`` is exact to within the width of the bucket
    the true quantile falls in — no samples are retained.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Mapping[str, str],
        help: str = "",
        bounds: Sequence[float] = DEFAULT_BUCKETS_MS,
    ) -> None:
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError("histogram bounds must be non-empty and strictly increasing")
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile (0 <= q <= 1); None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            count, counts = self._count, list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        if count == 0:
            return None
        target = q * count
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(0.0, lo_obs)
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, lo_obs), hi_obs)
            cum += c
        return hi_obs

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (identical bounds required). Returns self."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({self.name}: {len(self.bounds)} vs {other.name}: {len(other.bounds)})"
            )
        with other._lock:
            counts = list(other._counts)
            count, total = other._count, other._sum
            lo, hi = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            self._min = min(self._min, lo)
            self._max = max(self._max, hi)
        return self

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            snap = {
                "name": self.name,
                "kind": self.kind,
                "labels": self.labels,
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
            }
        for q in (0.5, 0.95, 0.99):
            snap[f"p{int(q * 100)}"] = self.quantile(q)
        return snap

    @classmethod
    def from_snapshot(cls, snap: Mapping[str, Any]) -> "Histogram":
        h = cls(snap["name"], snap.get("labels") or {}, bounds=snap["bounds"])
        h._counts = [int(c) for c in snap["counts"]]
        h._count = int(snap["count"])
        h._sum = float(snap["sum"])
        h._min = math.inf if snap.get("min") is None else float(snap["min"])
        h._max = -math.inf if snap.get("max") is None else float(snap["max"])
        return h

    def render(self) -> list[str]:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        lines = []
        cum = 0
        for bound, c in zip(self.bounds + (math.inf,), counts):
            cum += c
            le = _fmt_labels(self.labels, f'le="{_fmt_value(bound)}"')
            lines.append(f"{self.name}_bucket{le} {cum}")
        labels = _fmt_labels(self.labels)
        lines.append(f"{self.name}_sum{labels} {_fmt_value(total)}")
        lines.append(f"{self.name}_count{labels} {count}")
        return lines


class MetricsRegistry:
    """Get-or-create registry of metric series keyed by (name, labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Any] = {}

    def _get(self, cls, name: str, help: str, labels: Mapping[str, Any], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, {k: str(v) for k, v in labels.items()}, help, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls) or m.kind != cls.kind:
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        bounds: Optional[Sequence[float]] = None,
        **labels: Any,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         bounds=tuple(bounds) if bounds else DEFAULT_BUCKETS_MS)

    def metrics(self) -> list[Any]:
        with self._lock:
            return sorted(self._metrics.values(),
                          key=lambda m: (m.name, _label_key(m.labels)))

    def snapshot(self) -> dict[str, Any]:
        """JSON-able view of every series (histograms with p50/p95/p99)."""
        return {"t": time.time(), "metrics": [m.snapshot() for m in self.metrics()]}

    def render(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE block per name)."""
        lines: list[str] = []
        seen: set[str] = set()
        for m in self.metrics():
            if m.name not in seen:
                seen.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
