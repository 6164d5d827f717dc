"""Cost-aware replica selection: the system-level analogue of ``repro_torch.dispatch``
(counterpart of ``repro/router/cost.py``: the same decisions on the same
signals).

The in-process dispatcher answers "which kernel tier runs this op best"; the
:class:`CostRouter` answers the same question one level up — "which *replica*
serves this request class best" — from the same two signal sources:

* **fleet profiles** (a priori): at startup each replica's (git SHA, chip)
  bucket is pulled from the fleet store and priced into a per-class seed cost
  (``serve_prefill`` at the nearest prompt length + ``max_new`` decode steps,
  best backend's min wall time).  Replicas on different chips therefore start
  with *different* costs — the heterogeneous-allocation argmin the paper
  sweeps offline, answered from measured history;
* **live EWMA latency** (a posteriori): every completion folds the observed
  end-to-end service time back into a per-(replica, class) EWMA, so the
  ranking tracks what the fleet could not know — current load, thermal
  state, a replica warming its caches after a restart.

Routing is argmin-cost with least-loaded tie-breaking (costs within
``tie_rel`` of the best are a tie), plus admission control: each replica
accepts at most ``queue_depth`` in-flight requests, and when every healthy
replica is full the request is shed (:class:`RouterBusy`) instead of queued
without bound.  No ``torch`` import anywhere on this path — the router
process stays a few-ms-startup front door.
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Optional

# Fallback cost when a replica has neither a fleet seed nor live samples for
# a class: high enough that any measured replica wins, identical across cold
# replicas so the tie-break (least-loaded) spreads the exploration.
DEFAULT_COST_S = 0.25


class RouterBusy(RuntimeError):
    """Every healthy replica is at its queue-depth bound — shed the request."""


class NoReplicaAvailable(RuntimeError):
    """No replica is currently healthy (e.g. all mid-restart)."""


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < max(1, n):
        b <<= 1
    return b


def class_of(prompt_len: int, max_new: int) -> str:
    """Request class: power-of-two (prompt length, decode length) bucket.

    Mirrors the engine's own signature bucketing — prefill compiles per
    distinct prompt length, so callers already bucket lengths; the class is
    the routing-table key for seed costs and EWMA state.
    """
    return f"p{_pow2_bucket(prompt_len)}/n{_pow2_bucket(max_new)}"


_CLASS_RE = re.compile(r"^p(\d+)/n(\d+)$")
# ProfileStore keys are "op|backend|sig" with sig like "int32[1,16]" for a
# prefill's (1, prompt_len) token array.
_PREFILL_SIG_RE = re.compile(r"\[1,(\d+)\]$")


@dataclasses.dataclass
class SeedCosts:
    """Per-class a-priori costs priced from one fleet profile bucket."""

    prefill_s: dict[int, float]  # prompt_len -> best-backend min seconds
    decode_s: Optional[float]  # per decode tick, best backend
    match: str = "miss"  # fleet pull match quality (exact/chip/miss)

    def cost(self, cls: str) -> Optional[float]:
        m = _CLASS_RE.match(cls)
        if not m or self.decode_s is None or not self.prefill_s:
            return None
        plen, max_new = int(m.group(1)), int(m.group(2))
        nearest = min(self.prefill_s, key=lambda p: abs(p - plen))
        return self.prefill_s[nearest] + max_new * self.decode_s


def seed_costs_from_store(store: Any, match: str = "miss") -> Optional[SeedCosts]:
    """Price a pulled ProfileStore into :class:`SeedCosts`.

    Scans ``serve_prefill`` / ``serve_decode`` entries (the serving engine's
    dispatch ops) and keeps, per prompt length, the best backend's minimum
    observed wall time.  Returns None when the bucket carries nothing the
    router can price — the replica then starts on the default cost and live
    EWMA takes over from the first completion.
    """
    if store is None:
        return None
    prefill: dict[int, float] = {}
    decode: Optional[float] = None
    for key, entry in getattr(store, "_entries", {}).items():
        if entry.count == 0 or entry.min_s == float("inf"):
            continue
        parts = key.split("|")
        if len(parts) != 3:
            continue
        op, _backend, sig = parts
        if op == "serve_prefill":
            m = _PREFILL_SIG_RE.search(sig)
            if m:
                plen = int(m.group(1))
                prefill[plen] = min(prefill.get(plen, float("inf")), entry.min_s)
        elif op == "serve_decode":
            decode = entry.min_s if decode is None else min(decode, entry.min_s)
    if not prefill or decode is None:
        return None
    return SeedCosts(prefill_s=prefill, decode_s=decode, match=match)


@dataclasses.dataclass
class ReplicaSignal:
    """Everything the router knows about one replica."""

    name: str
    url: str = ""
    healthy: bool = False
    inflight: int = 0
    completed: int = 0
    failed: int = 0
    ewma_s: dict[str, float] = dataclasses.field(default_factory=dict)
    ewma_all_s: Optional[float] = None
    seed: Optional[SeedCosts] = None


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routing choice: where, at what predicted cost, from which signal."""

    replica: str
    url: str
    cls: str
    cost_s: float
    source: str  # ewma | ewma-any | seed | cold
    inflight: int  # replica in-flight count at decision time (pre-begin)

    def payload(self) -> dict[str, Any]:
        """Trace-event payload, shaped like a dispatch decision's."""
        return {"replica": self.replica, "class": self.cls,
                "cost_ms": round(self.cost_s * 1e3, 4), "source": self.source,
                "inflight": self.inflight}


class CostRouter:
    """Argmin-cost replica selection with admission control.

    Thread-safe: HTTP handler threads route/complete concurrently while the
    replica manager's supervisor thread flips health state.  ``registry`` (a
    :class:`repro_torch.metrics.registry.MetricsRegistry`) gets per-replica
    queue-depth gauges and up/down state gauges maintained in place.
    """

    def __init__(
        self,
        *,
        queue_depth: int = 16,
        ewma_alpha: float = 0.25,
        tie_rel: float = 0.10,
        default_cost_s: float = DEFAULT_COST_S,
        registry: Optional[Any] = None,
    ) -> None:
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1 (got {queue_depth})")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1] (got {ewma_alpha})")
        self.queue_depth = queue_depth
        self.ewma_alpha = ewma_alpha
        self.tie_rel = tie_rel
        self.default_cost_s = default_cost_s
        self.registry = registry
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaSignal] = {}
        self._rr = 0  # final round-robin tie-break cursor
        self.rejected = 0

    # -- membership / health (ReplicaManager callbacks) -----------------------

    def add_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.setdefault(name, ReplicaSignal(name))
        self._gauges(name)

    def seed_replica(self, name: str, store: Any, match: str = "miss") -> bool:
        """Install fleet-pulled seed costs for one replica; True if priceable."""
        seed = seed_costs_from_store(store, match=match)
        with self._lock:
            r = self._replicas.setdefault(name, ReplicaSignal(name))
            r.seed = seed
        return seed is not None

    def mark_up(self, name: str, url: str) -> None:
        with self._lock:
            r = self._replicas.setdefault(name, ReplicaSignal(name))
            r.healthy = True
            r.url = url
        self._gauges(name)

    def mark_down(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.healthy = False
        self._gauges(name)

    # -- cost model -----------------------------------------------------------

    def _cost(self, r: ReplicaSignal, cls: str) -> tuple[float, str]:
        """Predicted service seconds for ``cls`` on ``r`` + signal source."""
        ewma = r.ewma_s.get(cls)
        if ewma is not None:
            return ewma, "ewma"
        if r.ewma_all_s is not None:
            return r.ewma_all_s, "ewma-any"
        if r.seed is not None:
            seeded = r.seed.cost(cls)
            if seeded is not None:
                return seeded, "seed"
        return self.default_cost_s, "cold"

    def route(self, cls: str) -> RouteDecision:
        """Pick the argmin-cost healthy replica with a free queue slot.

        Ties (costs within ``tie_rel`` of the minimum) break to the
        least-loaded replica, then round-robin — so a cold fleet of
        identical replicas load-balances instead of convoying onto one.
        Raises :class:`NoReplicaAvailable` (nothing healthy — callers may
        wait and retry) or :class:`RouterBusy` (healthy but all queues full —
        callers shed).
        """
        with self._lock:
            healthy = [r for r in self._replicas.values() if r.healthy]
            if not healthy:
                raise NoReplicaAvailable(
                    f"0/{len(self._replicas)} replicas healthy")
            open_ = [r for r in healthy if r.inflight < self.queue_depth]
            if not open_:
                self.rejected += 1
                raise RouterBusy(
                    f"all {len(healthy)} healthy replicas at queue depth "
                    f"{self.queue_depth}")
            scored = [(self._cost(r, cls), r) for r in open_]
            best_cost = min(c for (c, _src), _r in scored)
            tied = [(c, src, r) for (c, src), r in scored
                    if c <= best_cost * (1.0 + self.tie_rel)]
            least = min(r.inflight for _c, _s, r in tied)
            tied = [t for t in tied if t[2].inflight == least]
            self._rr += 1
            cost, source, r = tied[self._rr % len(tied)]
            return RouteDecision(replica=r.name, url=r.url, cls=cls,
                                 cost_s=cost, source=source,
                                 inflight=r.inflight)

    # -- in-flight + feedback -------------------------------------------------

    def begin(self, name: str) -> None:
        with self._lock:
            r = self._replicas[name]
            r.inflight += 1
        self._gauges(name)

    def end(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None and r.inflight > 0:
                r.inflight -= 1
        self._gauges(name)

    def complete(self, name: str, cls: str, seconds: float) -> None:
        """Fold one observed end-to-end service time into the EWMA signals."""
        a = self.ewma_alpha
        with self._lock:
            r = self._replicas[name]
            r.completed += 1
            prev = r.ewma_s.get(cls)
            r.ewma_s[cls] = seconds if prev is None else (1 - a) * prev + a * seconds
            r.ewma_all_s = (seconds if r.ewma_all_s is None
                            else (1 - a) * r.ewma_all_s + a * seconds)

    def fail(self, name: str, *, dead: bool = False) -> None:
        """Record a forward failure; ``dead`` marks the replica down outright
        (connection refused/reset — the process is gone) so no further
        requests route to it until the manager confirms a restart."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.failed += 1
            if dead:
                r.healthy = False
        self._gauges(name)

    # -- introspection --------------------------------------------------------

    def _gauges(self, name: str) -> None:
        if self.registry is None:
            return
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            inflight, healthy = r.inflight, r.healthy
        self.registry.gauge("repro_router_replica_queue_depth",
                            "in-flight requests per replica",
                            replica=name).set(inflight)
        self.registry.gauge("repro_router_replica_up",
                            "replica routable (1) or down (0)",
                            replica=name).set(1.0 if healthy else 0.0)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "queue_depth": self.queue_depth,
                "rejected": self.rejected,
                "replicas": {
                    r.name: {
                        "healthy": r.healthy,
                        "inflight": r.inflight,
                        "completed": r.completed,
                        "failed": r.failed,
                        "ewma_ms": {c: round(v * 1e3, 3)
                                    for c, v in sorted(r.ewma_s.items())},
                        "seeded": r.seed is not None,
                        "seed_match": r.seed.match if r.seed else None,
                    }
                    for r in self._replicas.values()
                },
            }
