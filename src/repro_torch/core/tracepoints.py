"""Static tracepoints: the USDT analogue, counterpart of
``repro/core/tracepoints.py``.

USDT probes are markers compiled into the binary: a nop when disabled, an
event a consumer can read when enabled.  In the port:

* ``tp.point(name, value)`` is written into the model and step source (a
  static marker, like USDT's ``DTRACE_PROBE``).
* **Disabled** (the default), ``point`` returns after one thread-local
  check: it dispatches no op, so a step runs, and a CUDA graph captures,
  exactly the ops it would without the marker.  ``value`` may be a zero-
  argument callable, evaluated only when tracing is on, for a value whose
  computation would itself be an op (``lambda: guess[0]``).
* **"tape"**: each value becomes a 0-dim tensor on its device (an array is
  reduced to its f32 mean) and is aggregated into a tape by the JAX rules
  (``last | sum | max | count``).  ``collect(fn)`` makes ``fn`` return
  ``(out, tape)``, ``tape = {name: (value, fire_count)}``; inside a
  :class:`~repro_torch.serving.compiled.CompiledStep` the tape's values
  are outputs of the captured graph, refreshed by every replay (the fire
  counts are Python ints: how often a point fires is fixed by the code
  path, as it is by the trace in JAX).  The cost is a few 0-dim ops on the
  card.
* **"callback"**: the trap.  The value is read to the host (``.item()``
  for a 0-dim value, a copy to host memory for an array: a device sync)
  and recorded in the :class:`~repro_torch.core.events.EventLog` as kind
  ``probe``, the host-side cost that the JAX package's ``jax.debug.callback``
  shows.  A sync cannot be captured into a CUDA graph: callback mode
  refuses a capture, naming it, and never runs the step eagerly instead.

The mode is thread-local state read at call time, so ``enable`` must
surround the calls that should fire (for a compiled step, its eager call
and its capture).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.events import GLOBAL_LOG, EventLog
from repro_torch.kernels._build import refuse_in_capture

_STATE = threading.local()
AGGS = ("last", "sum", "max", "count")


def _state():
    if not hasattr(_STATE, "mode"):
        _STATE.mode = None  # None | "tape" | "callback"
        _STATE.tape = None
        _STATE.log = GLOBAL_LOG
    return _STATE


def tracing_enabled() -> bool:
    return getattr(_STATE, "mode", None) is not None


@contextmanager
def enable(mode: str = "tape", log: EventLog | None = None) -> Iterator[None]:
    """Enable tracepoints for the calls made within this context (flipping
    the USDT semaphore)."""
    if mode not in ("tape", "callback"):
        raise ValueError(f"mode must be 'tape' or 'callback', got {mode!r}")
    st = _state()
    prev = (st.mode, st.tape, st.log)
    st.mode = mode
    st.log = GLOBAL_LOG if log is None else log  # (EventLog is falsy when empty)
    try:
        yield
    finally:
        st.mode, st.tape, st.log = prev


# the end of a trap's refusal inside a capture (``_build.refuse_in_capture``)
NO_SYNC = ("reads a value to the host inside a CUDA graph capture, which cannot sync: "
           "run it eagerly, or use tape mode")


def point(name: str, value: Any = None, agg: str = "last") -> None:
    """A static tracepoint; returns at once unless tracing is enabled.

    ``value``: a tensor, a Python number, a zero-argument callable giving
    one of those, or None (the point counts its fires).  ``agg``: how
    repeated fires of the same point combine on the tape.
    """
    mode = getattr(_STATE, "mode", None)
    if mode is None:
        return
    st = _STATE
    if callable(value):
        value = value()
    if value is None:
        value = 1
        agg = "count" if agg == "last" else agg
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    if mode == "callback":
        refuse_in_capture(f"tracepoint {name!r} in callback mode {NO_SYNC}")
        if isinstance(value, torch.Tensor):
            value = value.item() if value.dim() == 0 else value.detach().to("cpu")
        st.log.record("probe", name, value)
        return
    # tape mode
    if st.tape is None:
        # point() fired outside collect(): aggregate into a throwaway tape so
        # instrumented code still runs when the caller forgot collect().
        st.tape = {}
    tape = st.tape
    with torch.no_grad():
        if not isinstance(value, torch.Tensor):  # a host number: int32 or f32, as jnp
            value = torch.tensor(value, dtype=torch.int32 if isinstance(value, int)
                                 else torch.float32)
        scalar = value.detach() if value.dim() == 0 else _summarize(value)
        if name not in tape:
            first = torch.ones((), dtype=torch.int32, device=value.device) if agg == "count" \
                else scalar
            tape[name] = (first, 1)
            return
        old, n = tape[name]
        if agg == "last":
            new = scalar
        elif agg == "sum":
            new = old + scalar
        elif agg == "max":
            new = torch.maximum(old, scalar)
        else:  # count
            new = old + 1
    tape[name] = (new, n + 1)


def _summarize(value: torch.Tensor) -> torch.Tensor:
    # Tracepoints carry scalars (USDT argument registers); reduce arrays by
    # their f32 mean, in one op.
    return torch.mean(value, dtype=torch.float32)


def collect(fn: Callable) -> Callable:
    """Wrap ``fn`` so it returns ``(out, tape)``; the tape is ``{}`` unless
    tape mode is enabled."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        st = _state()
        if st.mode != "tape":
            return fn(*args, **kwargs), {}
        prev = st.tape
        st.tape = {}
        try:
            out = fn(*args, **kwargs)
            tape = st.tape
        finally:
            st.tape = prev
        return out, tape

    return wrapped
