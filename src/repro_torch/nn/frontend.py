"""Modality frontend stubs (counterpart of ``repro/nn/frontend.py``).

chameleon-34b (``vlm_stub``) and musicgen-large (``audio_stub``) specify
the transformer backbone only; the VQ-VAE image tokenizer and the EnCodec
codec are stubs.  The caller passes precomputed (B, S, d_model) patch or
frame embeddings as an extra input stream; the stub applies a learned
(d_model, d_model) projection without bias and ``models/lm.py`` adds the
result to the token embeddings (early fusion).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import core as nn


def frontend_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    return {"proj": nn.linear_init(pf, (D,), (D,), ("embed",), ("embed_out",), scale=0.02)}


def frontend_apply(p: dict, emb: torch.Tensor) -> torch.Tensor:
    """emb: precomputed (B, S, d_model) frame / patch embeddings."""
    return nn.linear(p["proj"], emb)
