"""Lifecycle event tracing: a trimmed copy of ``repro/core/events.py``.

Holds what the serving engine and the training supervisor use: request /
prefill / decode-tick / step / checkpoint / restart spawn-exit brackets with
span ids and parent links, the durations that pair them, and the ring's
bound with its count of evicted events (``maxlen``, ``dropped``).
Cross-process span contexts and JSON export stay in the JAX package until
the trace layer is ported (ROADMAP M11).
"""
from __future__ import annotations

import contextvars
import dataclasses
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator, Optional

_SPAN_IDS = itertools.count(1)  # process-unique span ids (0 = "no span")

# The current-span stack for this thread/task: events default their
# ``parent`` to its top.
_SPAN_STACK: contextvars.ContextVar[tuple[int, ...]] = contextvars.ContextVar(
    "repro_torch_span_stack", default=()
)


def next_span_id() -> int:
    return next(_SPAN_IDS)


def current_span() -> int:
    """The innermost open span in this thread/task's context (0 = none)."""
    stack = _SPAN_STACK.get()
    return stack[-1] if stack else 0


@contextmanager
def span_scope(span: int) -> Iterator[int]:
    """Make ``span`` the current parent for events recorded in this context
    (a request spawns at submit and exits ticks later, but its prefill must
    still nest under it)."""
    token = _SPAN_STACK.set(_SPAN_STACK.get() + (span,))
    try:
        yield span
    finally:
        _SPAN_STACK.reset(token)


@dataclasses.dataclass(frozen=True)
class Event:
    t: float  # monotonic seconds
    kind: str  # spawn | exit | ...
    name: str  # e.g. "request", "prefill", "decode_tick"
    payload: Any = None
    span: int = 0  # pairs spawn/exit of one unit; 0 = unspanned
    parent: int = 0  # enclosing span id (0 = root)


class EventLog:
    """Thread-safe append-only event log; ``maxlen`` bounds it as a ring that
    keeps the newest events, and ``dropped`` counts the ones it evicted."""

    def __init__(self, maxlen: int | None = None) -> None:
        self._events: deque[Event] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._dropped = 0

    @property
    def maxlen(self) -> int | None:
        return self._events.maxlen

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def record(
        self,
        kind: str,
        name: str,
        payload: Any = None,
        *,
        span: int = 0,
        parent: Optional[int] = None,
    ) -> None:
        if parent is None:
            parent = current_span()
        ev = Event(time.monotonic(), kind, name, payload, span, parent)
        with self._lock:
            if self._events.maxlen is not None and len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    @contextmanager
    def lifecycle(
        self, name: str, payload: Any = None, *, parent: Optional[int] = None
    ) -> Iterator[int]:
        """spawn/exit bracket; yields the span id shared by both events and
        makes it the current parent inside the block."""
        span = next_span_id()
        if parent is None:
            parent = current_span()
        self.record("spawn", name, payload, span=span, parent=parent)
        token = _SPAN_STACK.set(_SPAN_STACK.get() + (span,))
        try:
            yield span
        finally:
            _SPAN_STACK.reset(token)
            self.record("exit", name, payload, span=span, parent=parent)

    def events(self, kind: str | None = None, name: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if name is not None:
            evs = [e for e in evs if e.name == name]
        return evs

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def durations(self, name: str) -> list[float]:
        """Pair spawn/exit events of ``name`` by span id into durations, in
        exit order."""
        out: list[float] = []
        opened: dict[int, float] = {}
        for e in self.events(name=name):
            if e.kind == "spawn":
                opened[e.span] = e.t
            elif e.kind == "exit" and e.span in opened:
                out.append(e.t - opened.pop(e.span))
        return out


# Bounded: a long-lived server must not grow host memory without limit.
GLOBAL_LOG = EventLog(maxlen=1 << 18)
