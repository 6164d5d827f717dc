"""AdamW with a configurable moment dtype, f32 update math (counterpart of
``repro/training/optim.py``).

Plain functions on dicts of tensors, not ``torch.optim.AdamW``, whose decay
mask, moment storage and clip are not the reference's: here every update
runs in f32 on the fly, the moments are stored in ``moment_dtype``
(``bfloat16`` halves their memory), a leaf with fewer than 2 dims (norm
scales, biases) takes no weight decay, and the gradients are scaled by
min(1, grad_clip / global norm) first.  The step counter is a 0-dim int32
tensor on the params' device, incremented in place, as the JAX state holds
it; the schedule and the bias corrections are computed from it on the
device in f32, as the JAX package rounds them.  So the update needs no
device-to-host copy, and a CUDA graph that captured it counts the steps
and moves the learning rate on every replay.

Where the JAX package returns new arrays, :func:`adamw_update` writes the
params and moments in place (the port may, to save the memory of a second
copy) and returns the same dicts.  It updates a leaf UPDATE_CHUNK elements
at a time: the update is elementwise, so the chunks give the whole leaf's
bits, while its f32 temporaries stay small (on a whole leaf they would
set a train step's peak memory: gemma2-27b's embedding table, 1.18 B
entries, takes 4.7 GB a copy in f32, and the update makes ~6 copies).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any

import torch

Tree = Any
UPDATE_CHUNK = 1 << 26  # elements of a leaf that one round of the update's ops takes


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


def schedule(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio x peak, a 0-dim f32
    tensor from the (int) step tensor, in the JAX package's f32 operations.
    The cosine is taken in f64 and rounded to f32: torch's f32 cosine on
    the CPU is one ulp off the correctly rounded value that XLA's gives at
    some of the schedule's points."""
    step = step.float()
    warm = step / max(1.0, opt.warmup_steps)
    frac = (step - opt.warmup_steps) / max(1.0, opt.total_steps - opt.warmup_steps)
    frac = frac.clamp(0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (
        1 + torch.cos((math.pi * frac).double()).float())
    return opt.peak_lr * torch.where(step < opt.warmup_steps, warm, cos)


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
    device = leaves(params)[0].device
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _sharded(t: torch.Tensor) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")  # none until something imported it
    return mod is not None and isinstance(t, mod.DTensor)


@torch.no_grad()
def adamw_update(
    params: Tree, grads: Tree, state: dict, opt: AdamWConfig
) -> tuple[Tree, dict, dict[str, Any]]:
    """One AdamW step, in place (the step counter too); returns (params,
    state, metrics) with the metrics ``grad_norm`` (before the clip) and
    ``lr``, 0-dim f32 tensors."""
    step = state["step"]
    step.add_(1)
    gnorm = global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1, bc2 = 1 - b1 ** step.float(), 1 - b2 ** step.float()

    def upd(p, g, mu, nu):
        decay = opt.weight_decay and p.dim() >= 2  # no decay on norms / biases / scalars
        if not (p.is_contiguous() and mu.is_contiguous() and nu.is_contiguous()):
            raise ValueError("adamw_update: params and moments must be contiguous (updated in "
                             "place through flat views)")
        if _sharded(p):  # a DTensor's update runs on its local shards whole
            chunks = [(p, g, mu, nu)]
        else:
            flat = [t.reshape(-1) for t in (p, g, mu, nu)]
            chunks = [tuple(t[i:i + UPDATE_CHUNK] for t in flat)
                      for i in range(0, p.numel(), UPDATE_CHUNK)]
        for pc, gc, mc, nc in chunks:
            gc = gc.float() * clip
            mu32 = b1 * mc.float() + (1 - b1) * gc
            nu32 = b2 * nc.float() + (1 - b2) * gc.square()
            delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + opt.eps)
            if decay:
                delta = delta + opt.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * delta)
            mc.copy_(mu32)
            nc.copy_(nu32)

    _map(upd, params, grads, state["mu"], state["nu"])
    return params, state, {"grad_norm": gnorm, "lr": lr}
