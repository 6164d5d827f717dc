"""AdamW with a configurable moment dtype, f32 update math (counterpart of
``repro/training/optim.py``).

Plain functions on dicts of tensors, not ``torch.optim.AdamW``, whose decay
mask, moment storage and clip are not the reference's: here every update
runs in f32 on the fly, the moments are stored in ``moment_dtype``
(``bfloat16`` halves their memory), a leaf with fewer than 2 dims (norm
scales, biases) takes no weight decay, and the gradients are scaled by
min(1, grad_clip / global norm) first.  The step counter is a Python int,
so the schedule and the bias corrections are host numbers and the update
needs no device-to-host copy.

Where the JAX package returns new arrays, :func:`adamw_update` writes the
params and moments in place (the port may, to save the memory of a second
copy) and returns the same dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(opt: AdamWConfig, step: int) -> float:
    """Linear warmup -> cosine decay to min_lr_ratio x peak."""
    step = float(step)
    if step < opt.warmup_steps:
        return opt.peak_lr * step / max(1.0, opt.warmup_steps)
    frac = (step - opt.warmup_steps) / max(1.0, opt.total_steps - opt.warmup_steps)
    frac = min(max(frac, 0.0), 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * frac))
    return opt.peak_lr * cos


def _map(fn, *trees: Tree) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def init_opt_state(params: Tree, opt: AdamWConfig) -> dict:
    dt = getattr(torch, opt.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {"mu": _map(zeros, params), "nu": _map(zeros, params), "step": 0}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def adamw_update(
    params: Tree, grads: Tree, state: dict, opt: AdamWConfig
) -> tuple[Tree, dict, dict[str, Any]]:
    """One AdamW step, in place; returns (params, state, metrics) with the
    metrics ``grad_norm`` (a 0-dim f32 tensor, before the clip) and ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1, bc2 = 1 - b1**step, 1 - b2**step

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * g.square()
        delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + opt.eps)
        if opt.weight_decay and p.dim() >= 2:  # no decay on norms / biases / scalars
            delta = delta + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        mu.copy_(mu32)
        nu.copy_(nu32)

    _map(upd, params, grads, state["mu"], state["nu"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
