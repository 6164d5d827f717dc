"""Train step: microbatch gradient accumulation + AdamW (counterpart of
``repro/training/step.py``).

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The gradients come from ``torch.autograd.grad`` over
the param leaves (which ``init_train_state`` creates with
``requires_grad=True``); with several microbatches each one's gradients are
added into explicit buffers of ``grad_accum_dtype``, as the JAX step's scan
carry accumulates them, and not into ``.grad``, which would accumulate in
the bf16 param dtype.  The update (``optim.adamw_update``) then writes the
params and moments in place, and the static tracepoints ``train.loss`` and
``train.grad_norm`` fire (``core/tracepoints.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracepoints as tp
from repro_torch.models import lm
from repro_torch.training import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optim.AdamWConfig = optim.AdamWConfig()
    microbatches: int = 1
    grad_accum_dtype: str = "float32"  # 'bfloat16' = compressed accumulation


def _requires_grad(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def init_train_state(
    cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator | int = 0,
    device: str | torch.device = "cuda", params: dict | None = None,
) -> dict:
    """{"params", "opt"}: random weights from ``generator`` on ``device`` (or
    the given ``params``, e.g. converted from the JAX package), as leaves
    that require grad, and zero moments in ``cfg.moment_dtype``."""
    if params is None:
        params = lm.init_params(cfg, generator, device)
    params = _requires_grad(params)
    opt_cfg = dataclasses.replace(tcfg.opt, moment_dtype=cfg.moment_dtype)
    return {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The train state on the ``meta`` device: shapes and dtypes only."""
    return init_train_state(cfg, tcfg, 0, "meta")


def train_state_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the whole train state (the moments mirror the params)."""
    p_axes = lm.param_axes(cfg)
    return {"params": p_axes, "opt": {"mu": p_axes, "nu": p_axes, "step": ""}}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (B, S) int, "labels": (B, S) int} tensors on the
    params' device, and for an arch with a frontend optionally
    "frontend_embed" (B, S, d_model), split with the tokens over the
    microbatches.  metrics: loss, ce, z_loss, aux, tokens, grad_norm and
    lr, each a 0-dim f32 tensor on that device; with several
    microbatches ce is the mean loss and z_loss and aux are 0, as in the JAX
    step.
    """
    opt_cfg = dataclasses.replace(tcfg.opt, moment_dtype=cfg.moment_dtype)
    n_micro = tcfg.microbatches
    acc_dtype = getattr(torch, tcfg.grad_accum_dtype)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = optim.leaves(params)
        tokens, labels = batch["tokens"], batch["labels"]
        fe = batch.get("frontend_embed")
        if n_micro == 1:
            loss, metrics = lm.loss_fn(params, cfg, tokens, labels, fe)
            grads = _rebuild(params, iter(_grad(loss, leaves)))
        else:
            B = tokens.shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} % microbatches {n_micro}")
            mb = B // n_micro
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                loss_i, _ = lm.loss_fn(params, cfg, tokens[sl], labels[sl],
                                       None if fe is None else fe[sl])
                for a, g in zip(acc, _grad(loss_i, leaves)):
                    a.add_(g.to(acc_dtype))
                loss_sum = loss_sum + loss_i.detach()
            grads = _rebuild(params, ((a / n_micro).float() for a in acc))
            loss = loss_sum / n_micro
            zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
            metrics = {"ce": loss, "z_loss": zero, "aux": zero,
                       "tokens": torch.full((), float(tokens.numel()), device=tokens.device)}

        _, new_opt, opt_metrics = optim.adamw_update(params, grads, state["opt"], opt_cfg)
        tp.point("train.loss", loss)
        tp.point("train.grad_norm", opt_metrics["grad_norm"])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return {"params": params, "opt": new_opt}, {"loss": loss.detach(), **metrics,
                                                    **opt_metrics}

    return train_step


def _rebuild(like: Any, it) -> Any:
    """A tree shaped as ``like`` whose leaves are taken from ``it`` in order."""
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    return next(it)


def _grad(loss: torch.Tensor, leaves: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """d loss / d each leaf; zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives."""
    return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


def on_mesh(train_step: Callable, mesh: Any) -> Callable:
    """``train_step`` for a state that may live on ``mesh`` (DTensors,
    ``distributed.sharding.distribute``) or on no mesh (plain tensors), as
    the state is at each call (``Supervisor.resize`` moves it): on the mesh
    the step runs under ``mesh_scope(mesh)``, plain tensors it creates
    taken as replicated, the batch (the same whole batch on every rank) cut
    into each rank's rows (:func:`shard_batch`), and the metrics come back
    whole.  ``mesh`` None: ``train_step`` itself."""
    if mesh is None:
        return train_step

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.distributed.constrain import is_dtensor, mesh_scope

        if not is_dtensor(optim.leaves(state["params"])[0]):
            return train_step(state, batch)
        with mesh_scope(mesh), implicit_replication():
            state, metrics = train_step(state, shard_batch(batch, mesh))
        return state, {k: _whole(v) for k, v in metrics.items()}

    return step


def shard_batch(batch: dict, mesh: Any) -> dict:
    """The whole batch (the same on every rank) as DTensors under the
    activation rules (``batch, seq[, embed]``), each rank's rows cut
    locally: no communication."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import ACT_RULES, placements, spec_for

    out = {}
    for k, t in batch.items():
        axes = "batch,seq,embed" if t.dim() == 3 else "batch,seq"
        pl = placements(spec_for(tuple(t.shape), axes, ACT_RULES, mesh), mesh)
        shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        out[k] = DTensor.from_local(local, mesh, pl, run_check=False)
    return out


def _whole(t: Any) -> Any:
    """A 0-dim metric as a plain tensor (its replicated value)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t
