"""The train step captured as a CUDA graph: the counterpart of the JAX
driver's ``jax.jit(make_train_step(cfg, tcfg), donate_argnums=(0,))``.

:class:`CompiledTrainStep` wraps ``training/step.py``'s step for one state
and one batch shape in a :class:`~repro_torch.serving.compiled.CompiledStep`:
the first call runs eagerly on the capture's side stream (the kernels'
builds, K1b's plans, K3b's ticket counters for that stream, cuBLAS's
workspace, autograd's and the allocator's first-use work), the second
captures the whole step into a graph (forward, both remat recomputes,
the backward and the AdamW update; with several microbatches the
accumulation loop unrolled) and replays it, and every later call replays.

The graph's inputs are ``tokens`` and ``labels``, copied into static
buffers.  The params, the moments and the step counter are read and
written in place at the addresses the capture saw, the counterpart of the
donated state: the step refuses a state whose leaves are not the ones it
captured (a restore copies into them, ``runtime/supervisor.py``).  The
schedule and the bias corrections come from the step counter on the device
(``training/optim.py``), so each replay trains the next step.

A replay returns metrics (0-dim tensors) that live in the graph's pool and
are overwritten by the next replay: read them before calling again.  So
does the step's tracepoint tape (``core/tracepoints.py``), kept as
``.tape`` after each call: ``{"train.loss": ..., "train.grad_norm": ...,
"lm.loss": ..., "lm.embed_out": ..., "lm.stack_out": ...}`` when tape mode
was enabled around the eager call and the capture, empty otherwise.  On a
CPU device there is no graph: every call runs the step eagerly through the
static buffers.  A capture or replay that fails raises; nothing runs
eagerly in its place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracepoints as tp
from repro_torch.serving.compiled import Graphs
from repro_torch.training.optim import leaves
from repro_torch.training.step import TrainConfig, make_train_step


class CompiledTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` of ``cfg`` / ``tcfg``
    for the one state it was built for, as the replay of a captured graph
    on the state's device (eager on the CPU)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, state: dict) -> None:
        self._leaves = leaves(state)
        step = tp.collect(make_train_step(cfg, tcfg))

        def fn(tokens: torch.Tensor, labels: torch.Tensor) -> tuple[dict, dict]:
            (_, metrics), tape = step(state, {"tokens": tokens, "labels": labels})
            return metrics, tape

        self.graphs = Graphs(self._leaves[0].device)
        self.compiled = self.graphs.step(fn)
        self.tape: dict = {}

    def counts(self) -> dict[str, int]:
        """``calls``, ``captures`` and ``replays`` so far."""
        return self.compiled.counts()

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict[str, Any]]:
        now = leaves(state)
        if len(now) != len(self._leaves) or any(a is not b for a, b in zip(now, self._leaves)):
            raise ValueError("compiled train step called with a state whose tensors are not "
                             "the ones it was built for (restore into them in place)")
        metrics, self.tape = self.compiled(batch["tokens"], batch["labels"])
        return state, metrics

