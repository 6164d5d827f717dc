"""Lifecycle event tracing — the thread/process spawn-exit analogue
(counterpart of ``repro/core/events.py``; the same events, span ids, span
contexts and JSON).

Adaptyst's third profiling type is "tracing of spawning and exiting
threads/processes of a given program".  The unit of concurrency in this
framework is not an OS thread: it is the training step, the microbatch, the
checkpoint writer and the serving request.  This module records their
spawn/exit events on the host with monotonic timestamps, and is the sink for
uprobe-style host callbacks (repro_torch.core.uprobes).

Two properties mirror the kernel-side perf machinery:

* **Bounded storage** — an ``EventLog(maxlen=N)`` is a ring: once full, the
  oldest events are overwritten and counted in :attr:`EventLog.dropped`,
  exactly like a perf/eBPF ring buffer under backpressure.  The default is
  unbounded for short-lived tools; long-running servers should bound it
  (see :class:`repro_torch.trace.collector.TraceCollector`).
* **Span identity** — concurrent units interleave (request A's exit can land
  between request B's spawn and exit), so spawn/exit pairing cannot be a
  stack.  ``lifecycle()`` allocates a process-unique span id recorded on both
  bracket events; :meth:`EventLog.durations` pairs by span id, then by
  payload identity, and only falls back to stack order for legacy events.
* **Span hierarchy** — every event carries a ``parent`` span id, defaulted
  from a :mod:`contextvars`-based current-span stack that ``lifecycle()``
  pushes and pops.  contextvars are per-thread and copied into asyncio
  tasks, so concurrent serving requests nest under their own ancestors
  instead of whichever span another thread happens to have open.  The
  resulting parent links are what :func:`repro_torch.trace.collector.span_tree`
  folds into host/device timeline trees.
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

# The current-span stack: a tuple (immutable, so set/reset is race-free) of
# open span ids for this thread/task.  Events default their ``parent`` to the
# top of this stack.
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
    """Make ``span`` the current parent for events recorded in this context.

    Used when a span's bracket events are recorded apart from the work they
    enclose (e.g. a serving request spawns at submit and exits ticks later,
    but its prefill must still nest under it).
    """
    token = _SPAN_STACK.set(_SPAN_STACK.get() + (span,))
    try:
        yield span
    finally:
        _SPAN_STACK.reset(token)


# HTTP header carrying a serialized SpanContext across process boundaries
# (the W3C traceparent analogue for this framework's span-id space).
TRACEPARENT_HEADER = "X-Repro-Traceparent"


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Serializable cross-process span reference.

    Span ids are process-unique, not globally unique, so a remote reference
    needs three parts: a ``trace`` id naming the end-to-end request, the
    parent ``span`` id in the *origin* process's id space, and the ``origin``
    process identity (``name:pid``) that id space belongs to.  ``sent_unix``
    is the injector's wall clock at send time — one half of the handshake
    pair :mod:`repro_torch.trace.stitch` uses to estimate cross-host clock skew.

    The wire format is a single header value (``repro1;trace=..;span=..;
    origin=..;sent=..``); :meth:`extract` tolerates missing or garbage
    values by returning ``None`` — propagation is best-effort and must
    never fail a request.
    """

    trace: str
    span: int
    origin: str
    sent_unix: float = 0.0

    def inject(self) -> str:
        """The ``X-Repro-Traceparent`` header value for this context."""
        origin = self.origin.replace(";", "_").replace("=", "_")
        return (f"repro1;trace={self.trace};span={self.span};"
                f"origin={origin};sent={self.sent_unix!r}")

    @classmethod
    def extract(cls, value: Optional[str]) -> Optional["SpanContext"]:
        """Parse a header value; ``None`` on anything malformed."""
        if not value or not value.startswith("repro1;"):
            return None
        fields: dict[str, str] = {}
        for part in value.split(";")[1:]:
            k, sep, v = part.partition("=")
            if sep:
                fields[k.strip()] = v.strip()
        try:
            return cls(trace=fields["trace"], span=int(fields["span"]),
                       origin=fields["origin"],
                       sent_unix=float(fields.get("sent", 0.0)))
        except (KeyError, ValueError):
            return None

    def to_payload(self) -> dict[str, Any]:
        """The ``remote`` payload convention: embedding this dict under the
        ``"remote"`` key of a spawn payload marks the span as remotely
        parented; :func:`repro_torch.trace.collector.resolve_spans` lifts it onto
        ``Span.remote`` and :mod:`repro_torch.trace.stitch` re-links it to the
        origin process's span once both sessions are merged."""
        return {"trace": self.trace, "span": self.span, "origin": self.origin}


def remote_ref(payload: Any) -> Optional[dict[str, Any]]:
    """The remote-parent reference embedded in a span payload, if any."""
    if isinstance(payload, dict):
        ref = payload.get("remote")
        if isinstance(ref, dict) and isinstance(ref.get("span"), int) \
                and ref.get("origin"):
            return ref
    return None


@dataclasses.dataclass(frozen=True)
class Event:
    t: float  # monotonic seconds
    kind: str  # spawn | exit | probe | mark | dispatch | route | straggler | device
    name: str  # e.g. "step", "microbatch", "request", probe target
    payload: Any = None
    span: int = 0  # pairs spawn/exit of one unit; 0 = unspanned (legacy)
    parent: int = 0  # enclosing span id (0 = root); defaults from span_scope


def _pair_key(e: Event) -> Optional[Any]:
    """Pairing key for a spawn/exit event: span id, else hashable payload."""
    if e.span:
        return ("span", e.span)
    try:
        hash(e.payload)
    except TypeError:
        return None
    if e.payload is None:
        return None
    return ("payload", e.payload)


class EventLog:
    """Thread-safe append-only event log (the eBPF ring-buffer analogue).

    ``maxlen`` turns it into a bounded ring: the newest ``maxlen`` events are
    kept, evictions are counted in :attr:`dropped` (perf-buffer "lost
    samples" accounting — the collector never blocks the instrumented path).
    """

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

    def record(
        self,
        kind: str,
        name: str,
        payload: Any = None,
        *,
        span: int = 0,
        parent: Optional[int] = None,
        t: Optional[float] = None,
    ) -> None:
        """Append one event.  ``t`` overrides the timestamp (monotonic
        seconds) for events measured elsewhere — merged device slices carry
        their own clock; everything else stamps ``time.monotonic()`` here."""
        if parent is None:
            parent = current_span()
        ev = Event(time.monotonic() if t is None else t, kind, name, payload,
                   span, parent)
        with self._lock:
            if self._events.maxlen is not None and len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    @contextmanager
    def lifecycle(
        self, name: str, payload: Any = None, *, parent: Optional[int] = None
    ) -> Iterator[int]:
        """spawn/exit bracket for a step / microbatch / request.

        Yields the span id shared by both bracket events, so callers can
        attach child events to the same span.  The span becomes the current
        parent (via the contextvars stack) for anything recorded inside the
        block, and is itself parented to the span that encloses it —
        ``parent=`` overrides that for brackets whose causal parent is not
        the lexically enclosing one (e.g. a checkpoint recorded after its
        step closed).
        """
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

    def to_json(self) -> str:
        """JSON-serialise the log (payloads fall back to repr when needed).

        Top level is ``{"dropped": N, "maxlen": M|null, "events": [...]}`` so
        consumers can see ring-buffer losses alongside the surviving events.
        """
        import json

        def default(obj: Any) -> str:
            return repr(obj)

        with self._lock:
            rows = [dataclasses.asdict(e) for e in self._events]
            dropped, maxlen = self._dropped, self._events.maxlen
        return json.dumps(
            {"dropped": dropped, "maxlen": maxlen, "events": rows}, default=default
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def durations(self, name: str) -> list[float]:
        """Pair spawn/exit events of ``name`` into durations (exit order).

        Pairing is by span id when present, then by (hashable, non-None)
        payload identity — so interleaved units (request A exits between
        request B's spawn and exit) pair correctly.  Events carrying neither
        fall back to the legacy LIFO stack match.
        """
        out: list[float] = []
        open_by_key: dict[Any, list[float]] = {}
        stack: list[float] = []
        for e in self.events(name=name):
            key = _pair_key(e)
            if e.kind == "spawn":
                if key is not None:
                    open_by_key.setdefault(key, []).append(e.t)
                else:
                    stack.append(e.t)
            elif e.kind == "exit":
                opened = open_by_key.get(key) if key is not None else None
                if opened:
                    out.append(e.t - opened.pop())
                elif key is None and stack:
                    out.append(e.t - stack.pop())
        return out


# Global default log (like the kernel's shared perf buffer); components may
# construct private logs for isolation.  Bounded: a long-lived server must
# not grow host memory without limit — see GLOBAL_LOG_MAXLEN.
GLOBAL_LOG_MAXLEN = 1 << 18  # 262144 events ≈ tens of MB worst case
GLOBAL_LOG = EventLog(maxlen=GLOBAL_LOG_MAXLEN)
