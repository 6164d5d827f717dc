"""Continuous-batching serving engine (fixed decode slots).

Counterpart of ``repro/serving/engine.py`` without the dispatcher branch
(profile-guided dispatch is ROADMAP item M8).  A fixed ``max_batch``-slot
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
replay.  Sampling stays outside the graphs.  On a CPU device the same
static buffers feed eager calls.  ``compiled=False`` calls ``lm.prefill``
and ``lm.decode_step`` directly, the counterpart of ``jax.disable_jit``,
so that a check on the card can hold the two paths against each other.

Request lifecycle events (spawn/exit) and the ``prefill`` / ``decode_tick``
brackets flow into the :class:`~repro_torch.core.events.EventLog`, as in the
JAX engine.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import GLOBAL_LOG, EventLog, current_span, next_span_id, span_scope
from repro_torch.models import lm
from repro_torch.serving.compiled import CompiledStep, Graphs


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


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        scfg: ServeConfig,
        *,
        log: Optional[EventLog] = None,
        compiled: bool = True,
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.log = GLOBAL_LOG if log is None else log
        self.device = params["embed"]["table"].device
        B = scfg.max_batch
        self.caches = lm.init_caches(cfg, B, scfg.max_seq, self.device)
        self.compiled = compiled
        if compiled:
            # the steps close over these, not over self (no reference cycle
            # keeps a deleted engine's graphs and pool alive)
            caches, S = self.caches, scfg.max_seq
            self._graphs = Graphs(self.device)
            self._decode = self._graphs.step(
                lambda t, pos: lm.decode_step(params, cfg, t, pos, caches)[0])
            self._prefill_fn = lambda t: lm.prefill(params, cfg, t, max_seq=S)
            self._prefills: dict[int, CompiledStep] = {}
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
        self.log.record("spawn", "request", req.rid, span=req.span, parent=req.parent)
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
            with span_scope(req.span), self.log.lifecycle("prefill", req.rid):
                logits, new_caches = self.prefill(torch.tensor([req.prompt], dtype=torch.long))
                # stacked leaves are (n_periods, B, ...): the slot is axis 1
                for name, sub in self.caches.items():
                    _copy_into_slot(sub, new_caches[name], slot, 1 if name == "blocks" else 0)
                req.out.append(int(self._sample(logits)[0]))
                self.cur_pos[slot] = len(req.prompt)
            self.active[slot] = req

    def _decode_tick(self) -> list[Request]:
        live = [r for r in self.active if r is not None]
        if not live:
            return []
        tokens = np.zeros(self.scfg.max_batch, np.int64)
        for r in live:
            tokens[r.slot] = r.out[-1]
        with self.log.lifecycle("decode_tick", len(live)):
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
        return finished

    # -- the two serving surfaces ---------------------------------------------

    def prefill(self, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``lm.prefill`` of one prompt, tokens (1, S) on any device: (logits
        (1, V) f32, caches of batch 1).  Compiled, the outputs belong to this
        length's graph and are overwritten by its next replay."""
        if not self.compiled:
            return lm.prefill(self.params, self.cfg, tokens.to(self.device),
                              max_seq=self.scfg.max_seq)
        step = self._prefills.get(tokens.shape[1])
        if step is None:
            step = self._prefills[tokens.shape[1]] = self._graphs.step(self._prefill_fn)
        return step(tokens)

    def decode(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """``lm.decode_step`` of every slot against ``self.caches``, advanced
        in place: tokens (max_batch,) int64 and positions (max_batch,) int32
        on any device -> logits (max_batch, V) f32.  Compiled, the logits
        belong to the decode graph and are overwritten by its next replay."""
        if not self.compiled:
            return lm.decode_step(self.params, self.cfg, tokens.to(self.device),
                                  positions.to(self.device), self.caches)[0]
        return self._decode(tokens, positions)

    def compiled_counts(self) -> dict:
        """Calls, captures and replays of the decode step and of each prompt
        length's prefill (empty when the engine is not compiled)."""
        if not self.compiled:
            return {}
        return {"decode": self._decode.counts(),
                "prefill": {n: step.counts() for n, step in self._prefills.items()}}

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
