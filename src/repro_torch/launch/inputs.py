"""Meta-device stand-ins for every model input (no memory): the counterpart
of ``repro/launch/inputs.py``.

``input_specs(cfg, shape)`` returns the batch of the shape's step kind,
with the JAX package's dtypes and shapes; ``abstract_decode_caches`` the
caches a decode shape's step reads, sized for its context.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    act = lm.torch_dtype(cfg.activation_dtype)
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        if cfg.frontend != "text":
            batch["frontend_embed"] = _meta((B, S, cfg.d_model), act)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": _meta((B, S), i32)}
        if cfg.frontend != "text":
            batch["frontend_embed"] = _meta((B, S, cfg.d_model), act)
        return batch
    if shape.kind == "decode":
        batch = {"tokens": _meta((B,), i32), "cur_pos": _meta((B,), i32)}
        if cfg.frontend != "text":
            batch["frontend_embed"] = _meta((B, 1, cfg.d_model), act)
        return batch
    raise ValueError(shape.kind)


def abstract_decode_caches(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """Caches sized for the shape's context length (decode shapes only)."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a decode shape")
    return lm.init_caches(cfg, shape.global_batch, shape.seq_len, "meta")
