"""Continuous-batching serving engine (fixed decode slots).

Counterpart of ``repro/serving/engine.py``.  A fixed ``max_batch``-slot
decode batch keeps its caches on the device; a new request is prefilled
alone (batch 1) and its cache is copied into its slot in place; one batched
decode step per tick advances every slot.

Every cache leaf is ``(B, ...)``, or ``(n_periods, B, ...)`` under
``blocks``: attention KV caches and their ``pos_ids``, the Mamba blocks'
``conv`` windows (B, d_conv - 1, DI) and f32 ``ssm`` states (B, DI, N), and
the RWKV6 blocks' ``shift`` vectors (B, D) and f32 ``wkv`` states
(B, H, K, V).  A prefill's
leaves are copied into the slot along that batch axis, so a recurrent state
is replaced whole when a request takes over a slot.

Both surfaces are compiled, as the JAX engine ``jax.jit``s them
(``serving/compiled.py``): on the card each prefill and each decode tick is
the replay of a CUDA graph, captured once per prompt length (batch 1) and
once for the decode step (always ``max_batch`` rows).  The first call of
each shape runs eagerly and the second captures.  The tick's tokens and
positions and the prompt's tokens are written into static buffers before a
replay; the decode graph reads and writes ``caches`` in place (the
counterpart of ``donate_argnums``); a prefill replay's caches live in the
graphs' memory pool and are copied into the request's slot before the next
replay.  Sampling stays outside the graphs.  Each kept prefill graph holds
its outputs (logits and a batch-1 cache set at ``max_seq``) in the pool,
so the engine keeps at most ``max_prefill_graphs`` of them: a new prompt
length past the cap frees the least recently used length's graph with its
static buffers and outputs, and that length starts over (eager, capture,
replays) if it comes back.  Prompt lengths are not bucketed or padded:
that would change positions, and with them the tokens.  On a CPU device the same
static buffers feed eager calls.  ``compiled=False`` calls ``lm.prefill``
and ``lm.decode_step`` directly, the counterpart of ``jax.disable_jit``,
so that a check on the card can hold the two paths against each other.

With a ``dispatcher`` (``dispatch/``), each surface exists once per
backend target that runs on the engine's device (``kernel`` and ``plain``
on a CUDA device, ``plain`` on the CPU), each variant run inside its
target's ``kernels.ops.impl_scope`` (``with_impl``), and every call is
routed by the dispatcher and recorded as a ``dispatch`` event.  Compiled,
that is one :class:`CompiledStep` per target for the decode step and one
per (target, prompt length) for prefill: a graph keeps the kernels its
capture launched, so each tier has graphs of its own.  They share the
engine's graph pool and ``max_prefill_graphs`` counts every (target,
length) graph.  Every decode variant reads and writes the same ``caches``
in place, so the tier may change between ticks.  The a-priori estimates
come from one ``sdfg.extract`` run of each surface under ``impl="auto"``
per token signature (``dispatch/cost.py``); a decode step is priced
against a scratch set of caches of the same shapes, since the run updates
its caches in place and would advance the recurrent states of the served
requests.  Policy ``static`` prices nothing.

Request lifecycle events (spawn/exit) and the ``prefill`` / ``decode_tick``
brackets flow into the :class:`~repro_torch.core.events.EventLog`, as in the
JAX engine; while a live device profiler is active each bracket's work runs
under its ``span=<id>`` annotation (``trace/liveprof.py``), so the kernels a
prefill or a tick launched (or the graph it replayed) bind to its span.
``metrics=`` (a :class:`~repro_torch.metrics.registry.MetricsRegistry`) adds
the JAX engine's gauges, ``repro_serve_queue_depth`` and
``repro_serve_active_slots``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import GLOBAL_LOG, EventLog, current_span, next_span_id, span_scope
from repro_torch.core import sdfg
from repro_torch.dispatch.cost import estimate_run
from repro_torch.dispatch.dispatcher import Dispatcher, with_impl
from repro_torch.dispatch.profiles import signature
from repro_torch.models import lm
from repro_torch.serving.compiled import CompiledStep, Graphs
from repro_torch.trace.liveprof import device_annotation


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 512
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1 = never; synthetic workloads run to max_new
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    span: int = 0  # trace span id shared by the request's spawn/exit events
    parent: int = 0  # enclosing span at submit time (e.g. the driver's run span)
    t_active: float = 0.0  # monotonic instant the request won a decode slot


def _copy_into_slot(dst: Any, src: Any, slot: int, batch_axis: int) -> None:
    """dst[..., slot, ...] = src[..., 0, ...] along ``batch_axis``, leaf by leaf."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into_slot(dst[k], src[k], slot, batch_axis)
    else:
        dst.select(batch_axis, slot).copy_(src.select(batch_axis, 0))


def _bind(impl: Optional[str], fn: Callable) -> Callable:
    """``fn`` under ``impl`` (``with_impl``), or as it is for no dispatcher."""
    return fn if impl is None else with_impl(impl, fn)


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        scfg: ServeConfig,
        *,
        log: Optional[EventLog] = None,
        compiled: bool = True,
        max_prefill_graphs: int = 4,
        dispatcher: Optional[Dispatcher] = None,
        metrics: Optional[Any] = None,
    ) -> None:
        if max_prefill_graphs < 1:
            raise ValueError(f"max_prefill_graphs must be >= 1, got {max_prefill_graphs}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.log = GLOBAL_LOG if log is None else log
        self.device = params["embed"]["table"].device
        self.dispatcher = dispatcher
        # live occupancy gauges: queue depth and decode-slot use are states,
        # which the trace answers only by replaying it
        self._g_queue = self._g_slots = None
        if metrics is not None:
            self._g_queue = metrics.gauge(
                "repro_serve_queue_depth", "requests waiting for a decode slot")
            self._g_slots = metrics.gauge(
                "repro_serve_active_slots", "occupied decode slots")
        # the tiers this engine serves, target name -> kernels.ops impl: the
        # registry's targets that run on the engine's device (one unnamed
        # tier under the process default without a dispatcher)
        self._impls: dict[Optional[str], Optional[str]] = {None: None}
        if dispatcher is not None:
            self._impls = {t.name: t.impl for t in dispatcher.registry.available(self.device)}
            if not self._impls:
                raise ValueError(f"no target of {dispatcher.registry.names()} runs on "
                                 f"{self.device}")
            self._est_cache: dict[tuple[str, str], dict[str, float]] = {}
            # per-backend tuned-config tags, resolved at the first dispatch
            self._configs: Optional[dict[str, str]] = None
        B = scfg.max_batch
        self.caches = lm.init_caches(cfg, B, scfg.max_seq, self.device)
        self.compiled = compiled
        if compiled:
            # the steps close over these, not over self (no reference cycle
            # keeps a deleted engine's graphs and pool alive)
            caches, S = self.caches, scfg.max_seq
            self._graphs = Graphs(self.device)
            decode_fn = lambda t, pos: lm.decode_step(params, cfg, t, pos, caches)[0]  # noqa: E731
            self._decodes = {name: self._graphs.step(_bind(impl, decode_fn))
                             for name, impl in self._impls.items()}
            self._prefill_fn = lambda t: lm.prefill(params, cfg, t, max_seq=S)
            # (target, prompt length) -> its step, least recently used first
            self._prefills: OrderedDict[tuple[Optional[str], int], CompiledStep] = OrderedDict()
            self.max_prefill_graphs = max_prefill_graphs
            self._evictions = 0
        self.cur_pos = np.zeros(B, np.int32)  # next position per slot
        self.active: list[Optional[Request]] = [None] * B
        self.queue: list[Request] = []
        # submit() may be called from other threads; the queue hand-off is
        # the only state shared with the engine loop
        self._queue_lock = threading.Lock()
        self._rid = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)

    # -- client API ----------------------------------------------------------

    def submit(self, prompt: list[int], max_new: int = 32) -> int:
        req = Request(next(self._rid), list(prompt), max_new,
                      span=next_span_id(), parent=current_span())
        with self._queue_lock:
            self.queue.append(req)
            depth = len(self.queue)
        self.log.record("spawn", "request", req.rid, span=req.span, parent=req.parent)
        if self._g_queue is not None:
            self._g_queue.set(depth)
        return req.rid

    def pending(self) -> int:
        """Requests not yet delivered (queued + occupying a decode slot)."""
        with self._queue_lock:
            return len(self.queue) + sum(r is not None for r in self.active)

    def run_to_completion(self) -> dict[int, list[int]]:
        results: dict[int, list[int]] = {}
        while self.queue or any(self.active):
            for r in self.step():
                results[r.rid] = r.out
        return results

    # -- engine tick ----------------------------------------------------------

    def step(self) -> list[Request]:
        """One tick: admit to free slots (prefill), then batched decode."""
        self._admit()
        return self._decode_tick()

    def _admit(self) -> None:
        for slot in range(self.scfg.max_batch):
            if self.active[slot] is not None:
                continue
            with self._queue_lock:
                if not self.queue:
                    break
                req = self.queue.pop(0)
            req.slot = slot
            req.t_active = time.monotonic()
            with span_scope(req.span), self.log.lifecycle("prefill", req.rid) as psid, \
                    device_annotation(psid):
                logits, new_caches = self.prefill(torch.tensor([req.prompt], dtype=torch.long))
                # stacked leaves are (n_periods, B, ...): the slot is axis 1
                for name, sub in self.caches.items():
                    _copy_into_slot(sub, new_caches[name], slot, 1 if name == "blocks" else 0)
                req.out.append(int(self._sample(logits)[0]))
                self.cur_pos[slot] = len(req.prompt)
            self.active[slot] = req
        if self._g_queue is not None:
            self._g_queue.set(len(self.queue))
            self._g_slots.set(sum(r is not None for r in self.active))

    def _decode_tick(self) -> list[Request]:
        live = [r for r in self.active if r is not None]
        if not live:
            return []
        tokens = np.zeros(self.scfg.max_batch, np.int64)
        for r in live:
            tokens[r.slot] = r.out[-1]
        with self.log.lifecycle("decode_tick", len(live)) as dsid, device_annotation(dsid):
            logits = self.decode(torch.from_numpy(tokens), torch.from_numpy(self.cur_pos))
            nxt = self._sample(logits).tolist()  # the tick's one device-to-host sync
        finished: list[Request] = []
        for r in live:
            self.cur_pos[r.slot] += 1
            tok = int(nxt[r.slot])
            r.out.append(tok)
            hit_eos = tok == self.scfg.eos_id
            out_of_room = self.cur_pos[r.slot] + 1 >= self.scfg.max_seq
            if len(r.out) >= r.max_new or hit_eos or out_of_room:
                r.done = True
                self.active[r.slot] = None
                self.log.record("exit", "request", r.rid, span=r.span, parent=r.parent)
                finished.append(r)
        if finished and self._g_slots is not None:
            self._g_slots.set(sum(r is not None for r in self.active))
        return finished

    # -- the two serving surfaces ---------------------------------------------

    def prefill(self, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``lm.prefill`` of one prompt, tokens (1, S) on any device: (logits
        (1, V) f32, caches of batch 1).  Compiled, the outputs belong to this
        length's graph and are overwritten by its next replay.  With a
        dispatcher, the call goes to the tier it chooses."""
        if self.dispatcher is None:
            return self._prefill_on(None, tokens)
        variants = {name: functools.partial(self._prefill_on, name) for name in self._impls}
        return self._dispatched("serve_prefill", variants, tokens)

    def decode(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """``lm.decode_step`` of every slot against ``self.caches``, advanced
        in place: tokens (max_batch,) int64 and positions (max_batch,) int32
        on any device -> logits (max_batch, V) f32.  Compiled, the logits
        belong to the decode graph and are overwritten by its next replay.
        With a dispatcher, the call goes to the tier it chooses."""
        if self.dispatcher is None:
            return self._decode_on(None, tokens, positions)
        variants = {name: functools.partial(self._decode_on, name) for name in self._impls}
        return self._dispatched("serve_decode", variants, tokens, positions)

    def _prefill_on(self, name: Optional[str], tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        impl = self._impls[name]
        if not self.compiled:
            return _bind(impl, lm.prefill)(self.params, self.cfg, tokens.to(self.device),
                                           max_seq=self.scfg.max_seq)
        key = (name, tokens.shape[1])
        step = self._prefills.get(key)
        if step is None:
            if len(self._prefills) == self.max_prefill_graphs:
                # its graph, static buffers and outputs go back to the pool
                self._prefills.popitem(last=False)
                self._evictions += 1
            step = self._prefills[key] = self._graphs.step(_bind(impl, self._prefill_fn))
        else:
            self._prefills.move_to_end(key)
        return step(tokens)

    def _decode_on(self, name: Optional[str], tokens: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        if not self.compiled:
            return _bind(self._impls[name], lm.decode_step)(
                self.params, self.cfg, tokens.to(self.device), positions.to(self.device),
                self.caches)[0]
        return self._decodes[name](tokens, positions)

    def _dispatched(self, op: str, variants: dict, *args: torch.Tensor) -> Any:
        """Route one surface call through the dispatcher.

        The profile key is the token tensor's signature (it tells prompt
        lengths apart; params and caches are fixed per engine).  The
        a-priori estimates are priced once per (op, signature) from one
        ``sdfg.extract`` run of the surface under ``impl="auto"``, which the
        dispatcher overrides with measured times once warm.
        """
        disp = self.dispatcher
        sig = signature(args[0])
        if self._configs is None:
            self._configs = disp.active_configs()
        if disp.cfg.policy == "static":
            # pinned backend: the pricing would only be logged
            return disp.dispatch(op, variants, *args, sig=sig, configs=self._configs)
        key = (op, sig)
        if key not in self._est_cache:
            graph = sdfg.extract(with_impl("auto", self._canonical(op)), *args)
            self._est_cache[key] = {
                name: estimate_run(graph, disp.registry.get(name), disp.chip).seconds
                for name in self._impls
            }
        return disp.dispatch(op, variants, *args, estimates=self._est_cache[key], sig=sig,
                             configs=self._configs)

    def _canonical(self, op: str) -> Callable:
        """The surface ``op`` as the pricing run calls it: prefill as it is
        (it writes only the caches it returns), the decode step against a
        fresh scratch set of caches of the engine's shapes, so that pricing
        leaves ``self.caches`` (KV caches and recurrent states) as they were."""
        params, cfg, dev, S = self.params, self.cfg, self.device, self.scfg.max_seq
        if op == "serve_prefill":
            return lambda t: lm.prefill(params, cfg, t.to(dev), max_seq=S)
        scratch = lm.init_caches(cfg, self.scfg.max_batch, S, dev)
        return lambda t, pos: lm.decode_step(params, cfg, t.to(dev), pos.to(dev), scratch)[0]

    def compiled_counts(self) -> dict:
        """Calls, captures and replays of the decode step and of each kept
        prompt length's prefill (least recently used first), and how many
        prefill steps were evicted (empty when the engine is not compiled).
        With a dispatcher, ``decode`` and ``prefill`` are keyed by target
        first."""
        if not self.compiled:
            return {}
        if self.dispatcher is None:
            return {"decode": self._decodes[None].counts(),
                    "prefill": {n: step.counts() for (_, n), step in self._prefills.items()},
                    "prefill_evictions": self._evictions}
        prefill: dict[str, dict[int, dict[str, int]]] = {name: {} for name in self._impls}
        for (name, n), step in self._prefills.items():
            prefill[name][n] = step.counts()
        return {"decode": {name: step.counts() for name, step in self._decodes.items()},
                "prefill": prefill, "prefill_evictions": self._evictions}

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
