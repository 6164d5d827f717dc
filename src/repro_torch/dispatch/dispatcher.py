"""The dispatcher: argmin-cost placement, every decision an EventLog event.

Counterpart of ``repro/dispatch/dispatcher.py``.  Three policies (the
``--dispatch`` flag of the serve and train drivers):

    static     always the configured backend (the baseline everyone ships)
    roofline   argmin over a-priori cost-model estimates (act on analysis)
    profiled   roofline to open, then measured-beats-estimated: each candidate
               is explored until warm, after which the measured minimum
               decides (the Adaptyst loop — analysis seeds, profiles correct)

``dispatch()`` both *decides* and *executes*: it runs the chosen variant,
waits for the card (``torch.cuda.synchronize`` when the outputs are CUDA
tensors), feeds the call's time back into the
:class:`~repro_torch.dispatch.profiles.ProfileStore`, and records a
``dispatch`` event whose payload carries op, backend, estimate,
measurement and policy.  A call whose outputs are CUDA tensors is timed
between two CUDA events on the current stream, recorded before the call
and after it: the card's time from the call's start to its last kernel,
with the card's idle gaps while the host launches.  The host's wall time
would also hold whatever delays the calling thread after the wait
returns (another thread of a server holding the GIL for up to its switch
interval), which at a replayed graph of ~1 ms can outweigh the tiers'
difference and settle a tier on one unlucky sample.  Other calls are
timed on the host's clock.  Each dispatch event carries its own span id and
inherits the current span as parent, so decisions land in the span tree as
children of the request or step that caused them.

The dispatcher catches nothing: a kernel variant that fails to build or
launch raises through ``dispatch()``, and no call falls back to another
tier.  On a CUDA engine the kernel tier is always available, so a call
reaches the plain tier only by a decision that its event records (the
``static-fallback`` source is for a pinned backend that the caller did not
build, such as ``kernel`` on a CPU engine).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core.events import GLOBAL_LOG, EventLog, next_span_id
from repro_torch.core.sdfg import SDFG, Region
from repro_torch.dispatch.cost import CostEstimate, estimate_region
from repro_torch.dispatch.profiles import ProfileStore, _leaves, signature
from repro_torch.dispatch.registry import BackendRegistry, host_registry
from repro_torch.hw.specs import ChipSpec
from repro_torch.trace.liveprof import device_annotation

POLICIES = ("static", "roofline", "profiled")


def _start_event() -> Optional["torch.cuda.Event"]:
    """A timing event recorded on the current CUDA stream, or None in a
    process that has not used the card (then no call can return CUDA
    tensors)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _wait_for(out: Any, start: Optional["torch.cuda.Event"]) -> Optional[float]:
    """Block until the card has finished ``out``; returns the seconds
    between ``start`` and the end of ``out``'s work on the card (None for
    CPU outputs, or without ``start``)."""
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            end = None
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            torch.cuda.synchronize(leaf.device)
            return None if end is None else start.elapsed_time(end) / 1e3
    return None


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    policy: str = "profiled"
    static_backend: str = "kernel"  # used by policy="static"
    min_samples: int = 2  # profile warmth threshold (3 for compiled steps on the card)
    record_events: bool = True

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {self.policy!r}")


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    op: str
    backend: str
    sig: str
    est_s: float
    source: str  # static | static-fallback | roofline | measured | explore
    policy: str
    measured_s: Optional[float] = None  # wall time of the executed call
    config: str = ""  # active config point ("" = backend defaults)

    def payload(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["measured_s"] is None:  # unexecuted decision (partition/choose)
            del d["measured_s"]
        if not d["config"]:  # default point: keep the legacy payload shape
            del d["config"]
        return d


class Dispatcher:
    """Routes ops / requests / steps to the argmin-cost backend target."""

    def __init__(
        self,
        cfg: Optional[DispatchConfig] = None,
        *,
        registry: Optional[BackendRegistry] = None,
        store: Optional[ProfileStore] = None,
        log: Optional[EventLog] = None,
    ) -> None:
        self.cfg = cfg or DispatchConfig()
        self.registry = registry if registry is not None else host_registry()
        # `is not None`, not truthiness: an empty provided store (len 0) must
        # still be used — it may be filled by a later merge
        self.store = store if store is not None else ProfileStore(min_samples=self.cfg.min_samples)
        # warmth is a dispatch-policy knob, not a property of the loaded file
        self.store.min_samples = self.cfg.min_samples
        # new measurements are stamped with the code and the card that made
        # them, so a later --profile-in ages out what no longer matches (and
        # a store measured on the card never mixes with TPU samples)
        from repro_torch.trace.session import git_sha  # imports dispatch.profiles

        self.store.set_stamp(git_sha=git_sha(), chip=self.registry.chip.name)
        self.log = GLOBAL_LOG if log is None else log
        self.decisions: list[DispatchDecision] = []

    @property
    def chip(self) -> ChipSpec:
        return self.registry.chip

    def backends(self) -> list[str]:
        return self.registry.names()

    def active_configs(self) -> dict[str, str]:
        """Per-backend active tuned-config tags for the ``configs=`` params
        (``kernels.ops.config_tag``; all empty until ROADMAP M12 installs
        tuned configs, which reproduces the legacy keys)."""
        from repro_torch.kernels import ops

        return {t.name: ops.config_tag(t.impl) for t in self.registry.targets()}

    # -- decision ------------------------------------------------------------

    def choose(
        self,
        op: str,
        sig: str,
        estimates: Mapping[str, float],
        configs: Optional[Mapping[str, str]] = None,
    ) -> DispatchDecision:
        """Pick a backend given per-backend a-priori estimates (seconds).

        ``estimates`` keys restrict the candidate set (callers pass only the
        variants they built).  ``configs`` maps a backend to the config
        point its variant executes under; warmth, lookup and recording then
        use the full ``(op, backend, sig, config)`` key.
        """
        candidates = [b for b in estimates if b in self.registry]
        if not candidates:
            raise ValueError(f"no registered candidates among {sorted(estimates)}")
        cfg_of = (configs or {}).get
        policy = self.cfg.policy
        if policy == "static":
            if self.cfg.static_backend in candidates:
                backend, source = self.cfg.static_backend, "static"
            else:  # pinned backend not built here (e.g. kernel on a CPU engine)
                backend, source = candidates[0], "static-fallback"
            decision = DispatchDecision(op, backend, sig, estimates[backend],
                                        source, policy, config=cfg_of(backend, ""))
        elif policy == "roofline":
            backend = min(candidates, key=lambda b: estimates[b])
            decision = DispatchDecision(op, backend, sig, estimates[backend],
                                        "roofline", policy, config=cfg_of(backend, ""))
        else:  # profiled
            cold = [
                b for b in candidates
                if not self.store.warm(op, b, sig, cfg_of(b, ""))
            ]
            if cold:
                # explore the least-sampled cold candidate (roofline order
                # breaks ties so the best a-priori guess is measured first)
                backend = min(
                    cold,
                    key=lambda b: (
                        self.store.samples(op, b, sig, cfg_of(b, "")), estimates[b]
                    ),
                )
                decision = DispatchDecision(op, backend, sig, estimates[backend],
                                            "explore", policy, config=cfg_of(backend, ""))
            else:
                costs = {
                    b: self.store.combined_cost(op, b, sig, estimates[b],
                                                cfg_of(b, ""))
                    for b in candidates
                }
                backend = min(candidates, key=lambda b: costs[b][0])
                decision = DispatchDecision(
                    op, backend, sig, costs[backend][0], costs[backend][1],
                    policy, config=cfg_of(backend, ""),
                )
        self.decisions.append(decision)
        return decision

    # -- decide + execute + feed back -----------------------------------------

    def dispatch(
        self,
        op: str,
        variants: Mapping[str, Callable],
        *args: Any,
        estimates: Optional[Mapping[str, float]] = None,
        sig: Optional[str] = None,
        configs: Optional[Mapping[str, str]] = None,
        **kwargs: Any,
    ) -> Any:
        """Route one call: choose a variant, run it, wait for it, profile it,
        log it.

        ``sig`` lets hot callers supply a cheap profile key (the token
        tensor's signature) instead of walking a large params/state tree.
        ``configs`` (per-backend active config point) flows through to
        :meth:`choose` and keys the recorded sample.
        """
        sig = sig if sig is not None else signature(*args)
        if estimates is None:
            # no analysis supplied: flat priors, registry-order exploration
            estimates = {
                b: self.registry.get(b).launch_overhead_s
                for b in variants
                if b in self.registry
            }
        decision = self.choose(
            op, sig, {b: estimates[b] for b in variants if b in estimates},
            configs=configs,
        )
        idx = len(self.decisions) - 1  # choose() appended; backfill measurement
        fn = variants[decision.backend]
        # span id allocated before execution: a live device profiler binds
        # the launched kernels to it (trace/liveprof.py).  The annotation is
        # not a core/scopes.scope, which would rename every SDFG region and
        # by_scope key below it.
        span_id = next_span_id() if self.cfg.record_events else 0
        start = _start_event()
        t0 = time.perf_counter()
        with device_annotation(span_id):
            out = fn(*args, **kwargs)
            on_card = _wait_for(out, start)
        dt = time.perf_counter() - t0 if on_card is None else on_card
        self.store.record(op, decision.backend, sig, dt, config=decision.config)
        decision = dataclasses.replace(decision, measured_s=dt)
        self.decisions[idx] = decision
        if self.cfg.record_events:
            # own span id + context parent: the decision is a span-tree node
            # under the request/step whose span is current right now
            self.log.record("dispatch", op, decision.payload(), span=span_id)
        return out

    # -- whole-graph placement -------------------------------------------------

    def estimates_for_region(
        self, region: Region, backends: Optional[list[str]] = None
    ) -> dict[str, CostEstimate]:
        targets = self.registry.targets(backends)
        return {t.name: estimate_region(region, t, self.chip) for t in targets}

    def partition(
        self, graph: SDFG, *, backends: Optional[list[str]] = None
    ) -> dict[str, DispatchDecision]:
        """Assign every SDFG region to its argmin-cost backend.

        Uses the same choose() path as runtime dispatch, so profiled mode
        honours any warm measurements keyed by region name, and every
        assignment lands in the EventLog.
        """
        placement: dict[str, DispatchDecision] = {}
        for name, region in graph.regions().items():
            ests = {b: e.seconds for b, e in self.estimates_for_region(region, backends).items()}
            decision = self.choose(f"region:{name}", "<sdfg>", ests)
            placement[name] = decision
            if self.cfg.record_events:
                self.log.record("dispatch", f"region:{name}", decision.payload(),
                                span=next_span_id())
        return placement

    # -- reporting -------------------------------------------------------------

    def summary(self) -> dict[str, Any]:
        """Decision counts per (op, backend) — for driver JSON output.

        ``by_source`` separates exploration dispatches (``explore``) from
        steady-state ones (``measured``/``roofline``/``static``): a
        warm-started dispatcher (``--profile-in``) shows explore 0.
        ``explore_by_op`` counts the exploration dispatches per (op,
        backend), so a caller can tell a tier's explored calls in
        ``by_op`` from its settled ones.
        """
        by_op: dict[str, dict[str, int]] = {}
        by_source: dict[str, int] = {}
        explore_by_op: dict[str, dict[str, int]] = {}
        for d in self.decisions:
            by_op.setdefault(d.op, {}).setdefault(d.backend, 0)
            by_op[d.op][d.backend] += 1
            by_source[d.source] = by_source.get(d.source, 0) + 1
            if d.source == "explore":
                explored = explore_by_op.setdefault(d.op, {})
                explored[d.backend] = explored.get(d.backend, 0) + 1
        return {
            "policy": self.cfg.policy,
            "decisions": len(self.decisions),
            "by_op": by_op,
            "by_source": by_source,
            "explore_by_op": explore_by_op,
            "explore_dispatches": by_source.get("explore", 0),
            "profiled_keys": len(self.store),
        }


def with_impl(impl: str, fn: Callable) -> Callable:
    """``fn`` run inside ``kernels.ops.impl_scope(impl)``, so every op it
    reaches without an explicit ``impl`` takes that tier.

    The JAX version binds the impl at trace time, which a ``jax.jit`` bakes
    into the compiled variant.  Here it is bound at each call: the eager
    first call of a compiled step and its capture run under it, and a CUDA
    graph keeps the kernels its capture launched, so a replay runs that
    tier without reading the impl again.
    """
    from repro_torch.kernels import ops

    def wrapped(*args: Any, **kwargs: Any):
        with ops.impl_scope(impl):
            return fn(*args, **kwargs)

    wrapped.__name__ = f"{getattr(fn, '__name__', 'fn')}__{impl}"
    return wrapped
