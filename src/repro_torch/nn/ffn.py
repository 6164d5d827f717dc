"""FFN blocks: the dense gated GLU (counterpart of ``repro/nn/ffn.py``).

The MoE FFN arrives with the grouped-matmul kernel (ROADMAP items M10, K4).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import core as nn


def ffn_init(pf: nn.ParamFactory, cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    return {
        "w1": nn.linear_init(pf, (D,), (F,)),
        "w3": nn.linear_init(pf, (D,), (F,)),
        "w2": nn.linear_init(pf, (F,), (D,), scale=out_scale),
    }


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = nn.ACTIVATIONS[cfg.act]
    h = act(nn.linear(p["w1"], x).float()) * nn.linear(p["w3"], x).float()
    return nn.linear(p["w2"], h.to(x.dtype))
