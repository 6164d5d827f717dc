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

The graph's inputs are ``tokens`` and ``labels``, and for a frontend arch
(chameleon-34b, musicgen-large) built for a batch with ``frontend_embed``
(B, S, d_model) those too, copied into static buffers; the first call fixes
which, and a step built with embeddings refuses a batch without them, and
the reverse (one input set, as one shape).  With several microbatches the
embeddings are split with the tokens, as ``training/step.py`` splits
them.  The params, the moments and the step counter are read and
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

On a mesh (``mesh``, a ``DeviceMesh``; ``launch.train --mesh``) the state
is DTensors (``distributed.sharding.distribute``) and the step is
``training.step.on_mesh``'s: the staged batch, the same on every rank,
becomes DTensors cut locally.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracepoints as tp
from repro_torch.serving.compiled import Graphs
from repro_torch.training.optim import leaves
from repro_torch.training.step import TrainConfig, make_train_step, on_mesh


class CompiledTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` of ``cfg`` / ``tcfg``
    for the one state it was built for, as the replay of a captured graph
    on the state's device (eager on the CPU)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, state: dict,
                 mesh: Any = None) -> None:
        self._leaves = leaves(state)
        step = tp.collect(on_mesh(make_train_step(cfg, tcfg), mesh))

        def fn(tokens: torch.Tensor, labels: torch.Tensor, *embed: torch.Tensor
               ) -> tuple[dict, dict]:
            batch = {"tokens": tokens, "labels": labels}
            if embed:
                batch["frontend_embed"] = embed[0]
            (_, metrics), tape = step(state, batch)
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
        fe = batch.get("frontend_embed")
        inputs = (batch["tokens"], batch["labels"]) + (() if fe is None else (fe,))
        metrics, self.tape = self.compiled(*inputs)  # raises on another input set
        return state, metrics


