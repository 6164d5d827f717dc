"""repro_torch.router — a replica fleet behind a profile-guided front door
(counterpart of ``repro/router/``).

The system-level tier over :mod:`repro_torch.serving`: the engine becomes a
replica (:mod:`.replica` — an HTTP front over the port's compiled engine on
the card, or the deterministic synthetic engine for accelerator-free tests), a
supervisor keeps N of them alive (:mod:`.manager` — ready-file handshake,
healthz liveness, restart with exponential backoff), and a cost model picks
where each request class runs best (:mod:`.cost` — fleet (git SHA, chip)
profile seeds, then live per-replica EWMA latency, argmin with least-loaded
tie-breaking and bounded-queue admission control).  :mod:`.frontdoor` is the
single listener tying them together with drain-then-retry exactly-once
forwarding; :mod:`.loadgen` drives and verifies it.  Only a real
replica's engine construction (``replica._build_real_engine``) imports
``torch``: the router process and synthetic replicas never do.
"""
from repro_torch.router.cost import (
    DEFAULT_COST_S,
    CostRouter,
    NoReplicaAvailable,
    RouteDecision,
    RouterBusy,
    SeedCosts,
    class_of,
    seed_costs_from_store,
)
from repro_torch.router.frontdoor import FrontDoorServer, forward_generate, make_frontdoor
from repro_torch.router.manager import ReplicaHandle, ReplicaManager
from repro_torch.router.replica import (
    ReplicaServer,
    SyntheticEngine,
    expected_synthetic_tokens,
)

__all__ = [
    "DEFAULT_COST_S",
    "CostRouter",
    "FrontDoorServer",
    "NoReplicaAvailable",
    "ReplicaHandle",
    "ReplicaManager",
    "ReplicaServer",
    "RouteDecision",
    "RouterBusy",
    "SeedCosts",
    "SyntheticEngine",
    "class_of",
    "expected_synthetic_tokens",
    "forward_generate",
    "make_frontdoor",
    "seed_costs_from_store",
]
