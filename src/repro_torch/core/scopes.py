"""Named scopes: the counterpart of ``jax.named_scope``.

``with scope("final_norm"):`` pushes a name onto a thread-local path, which
``current()`` reads as ``"pos0_ga_dense/mixer_ga"``, the form of a JAX
equation's name stack.  The SDFG (``core/sdfg.py``) groups its nodes into
regions by this path, and ``core/uprobes.by_scope`` matches ops by it.

When ``torch.profiler`` is recording, a scope also opens a profiler range
of the same name, so a profile attributes device time to the module that
launched each kernel.  The range is a function-scope record
(``torch._C._profiler._RecordFunctionFast``, as compiled code's kernel
launches use), not a ``record_function`` user annotation: the profiler
links a kernel to the innermost function-scope range open at its launch,
and the port's kernels launch through ctypes, inside no aten op, so
under a user annotation their device time would be attributed to nothing.
A scope is host-only: it dispatches no op, launches no kernel and adds
nothing to a captured CUDA graph (a replay runs no Python, so it opens no
scope).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch

_STATE = threading.local()


def _stack() -> list[str]:
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    return stack


def current() -> str:
    """The open scopes of this thread, outermost first, joined by ``/``
    ("" outside every scope)."""
    return "/".join(_stack())


@contextmanager
def scope(name: str) -> Iterator[None]:
    stack = _stack()
    stack.append(name)
    try:
        if torch.autograd._profiler_enabled():
            with torch._C._profiler._RecordFunctionFast(name):
                yield
        else:
            yield
    finally:
        stack.pop()
