"""Compiled steps: one step at one set of shapes, run on the card as the
replay of a captured CUDA graph.  The serving engine compiles its prefill
and decode step here, and ``training/compiled.py`` the train step.

Counterpart of the ``jax.jit`` calls of ``repro/serving/engine.py``: the JAX
engine compiles its prefill once per prompt shape and its decode step once,
with the caches donated so that they are updated in place.  Here a
:class:`CompiledStep` wraps ``fn(*inputs)`` for one set of input shapes:

1. its first call runs ``fn`` eagerly.  It is a real call that counts its
   kernel launches like any other, and it does the host work a capture must
   not do first: the kernels' builds and loads, their shared-memory opt-ins,
   cuBLAS's handle and workspace, the allocator's blocks.  It runs on the
   side stream that the capture will use, so cuBLAS is warm there too;
2. its second call captures ``fn`` into a ``torch.cuda.CUDAGraph`` on that
   side stream, into the memory pool all of an engine's graphs share
   (:class:`Graphs`), and then replays it;
3. every later call replays the graph.

Inputs are copied into static device buffers before every call (never
inside the graph), and a replay returns the outputs of the capture, which
live in the pool and are overwritten by the next replay of any graph of the
pool: the caller reads or copies them before it replays again.  Anything
else ``fn`` reads or writes (weights, the decode caches) is read and written
in place at the addresses the capture saw, the counterpart of donated
buffers: a tensor rebound to a new one is not seen by later replays.

Kernel launches are counted by the wrappers in Python, which a replay does
not call: the capture runs under ``kernels.uncounted`` and each replay adds
what it counted (``kernels.add_launches``), so ``kernels.LAUNCHES`` stays the
number of kernels the card ran.  A capture runs inside
``trace.liveprof.capture_guard``, which stops a live profiler's open
session first: no profiler window spans a capture.  On a CPU device there
is no graph: every call copies its inputs into the static buffers and runs
``fn`` eagerly, so the CPU tests drive the same buffers.  A capture or replay that fails
raises; nothing runs eagerly in its place.

A graph bakes the launch plans of its capture: the tuned configs
(``kernels/ops.py``, ``tune/``) that were installed then.  So a step keeps
``ops.config_tag`` of both tiers from its first call, and a later call
under other tags raises (on the CPU too, where the step runs eagerly, so
the tests see the same refusal): a graph captured under one plan never
replays as if under another.  Install tuned configs before building the
steps (the drivers tune before the engine exists).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import add_launches, ops, uncounted
from repro_torch.trace.liveprof import capture_guard


class Graphs:
    """What one engine's (or one train step's) compiled steps share on the
    card: one memory pool (``torch.cuda.graph_pool_handle()``) and one side
    stream, on which each step's eager first call and its capture run.  On
    a CPU device both are None and its steps run eagerly."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        on_card = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.stream: Optional[torch.cuda.Stream] = torch.cuda.Stream(device) if on_card else None

    def step(self, fn: Callable[..., Any]) -> "CompiledStep":
        return CompiledStep(fn, self)


class CompiledStep:
    """``fn(*inputs)`` at one set of input shapes and dtypes: eager on the
    first call, captured on the second, replayed from then on (on the card).

    ``calls``, ``captures`` and ``replays`` count what happened, and
    ``launches`` holds the kernel launches the capture counted, which each
    replay adds to ``kernels.LAUNCHES``.
    """

    def __init__(self, fn: Callable[..., Any], graphs: Graphs) -> None:
        self.fn = fn
        self.graphs = graphs
        self.calls = self.captures = self.replays = 0
        self.launches: dict[str, int] = {}
        self._static: Optional[list[torch.Tensor]] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Any = None
        self.config_tags: Optional[tuple[str, str]] = None  # (kernel, plain) at the first call

    def counts(self) -> dict[str, int]:
        return {"calls": self.calls, "captures": self.captures, "replays": self.replays}

    def __call__(self, *inputs: torch.Tensor) -> Any:
        tags = (ops.config_tag("kernel"), ops.config_tag("plain"))
        if self.config_tags is None:
            self.config_tags = tags
        elif tags != self.config_tags:
            raise RuntimeError(f"compiled step built under tuned configs {self.config_tags} "
                               f"called under {tags}: its graph bakes the first ones' launch "
                               "plans; build a new step after installing tuned configs")
        static = self._stage(inputs)
        self.calls += 1
        stream = self.graphs.stream
        if stream is None:  # CPU: no graph
            return self.fn(*static)
        if self.calls == 1:
            main = torch.cuda.current_stream(self.graphs.device)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                out = self.fn(*static)
            main.wait_stream(stream)
            return out
        if self._graph is None:
            graph = torch.cuda.CUDAGraph()
            with capture_guard(), uncounted() as made, \
                    torch.cuda.graph(graph, pool=self.graphs.pool, stream=stream):
                self._out = self.fn(*static)
            self._graph, self.launches = graph, made
            self.captures += 1
        self._graph.replay()
        self.replays += 1
        add_launches(self.launches)
        return self._out

    def _stage(self, inputs: tuple[torch.Tensor, ...]) -> list[torch.Tensor]:
        """Copy the inputs into the static buffers (made at the first call)."""
        if self._static is None:
            self._static = [torch.empty(x.shape, dtype=x.dtype, device=self.graphs.device)
                            for x in inputs]
        want = [(tuple(s.shape), s.dtype) for s in self._static]
        got = [(tuple(x.shape), x.dtype) for x in inputs]
        if got != want:
            raise ValueError(f"compiled step called with inputs {got}; it was built for {want}")
        for s, x in zip(self._static, inputs):
            s.copy_(x)
        return self._static
