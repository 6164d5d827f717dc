"""RWKV6 "Finch" block: data-dependent decay and token shift, no attention.

Counterpart of ``repro/nn/rwkv.py``.  The time mix runs the WKV scan
(``ops.rwkv6_scan``: kernel K6 on the card) over a full sequence, and the
O(1) recurrence (``ops.rwkv6_step``) in decode mode.  State per sequence:
the last normalised input of each sub-layer (``shift``) and the (H, K, V)
f32 WKV state (``wkv``).  As in ``nn/attention.py``, the port writes the
cache tensors in place and returns the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constrain import is_dtensor
from repro_torch.kernels import ops
from repro_torch.nn import core as nn

Cache = dict[str, torch.Tensor]

_TARGETS = ("r", "k", "v", "w", "g")  # ddlerp mix targets


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    K = cfg.rwkv.head_dim
    return cfg.d_model // K, K


def _decay_init(shape: tuple[int, ...]) -> torch.Tensor:
    """Per-channel base decay in [-7, ~0): slow to fast forgetting."""
    n = shape[-1]
    base = -6.0 + 5.0 * (torch.arange(n, dtype=torch.float32) / max(1, n - 1)) ** 0.7
    return base.expand(shape)


def time_mix_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H, K = _dims(cfg)
    r = cfg.rwkv
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    f32 = torch.float32
    return {
        "mu_base": pf.param((D,), ("embed",), init="zeros"),
        "mu": pf.param((len(_TARGETS), D), (None, "embed"), init="zeros"),
        "mix_w1": pf.param((D, len(_TARGETS), r.mix_lora), ("embed", None, None)),
        "mix_w2": pf.param((len(_TARGETS), r.mix_lora, D), (None, None, "embed"), init="zeros"),
        "recv": nn.linear_init(pf, (D,), (H, K), ("embed",), ("heads", "head_dim")),
        "key": nn.linear_init(pf, (D,), (H, K), ("embed",), ("heads", "head_dim")),
        "value": nn.linear_init(pf, (D,), (H, K), ("embed",), ("heads", "head_dim")),
        "gate": nn.linear_init(pf, (D,), (H, K), ("embed",), ("heads", "head_dim")),
        "w0": pf.param((H, K), ("heads", "head_dim"), init=_decay_init, dtype=f32),
        "decay_w1": pf.param((D, r.decay_lora), ("embed", None)),
        "decay_w2": pf.param((r.decay_lora, H, K), (None, "heads", "head_dim"), init="zeros"),
        "u": pf.param((H, K), ("heads", "head_dim"), scale=0.5),
        "ln_scale": pf.param((H, K), ("heads", "head_dim"), init="ones", dtype=f32),
        "ln_bias": pf.param((H, K), ("heads", "head_dim"), init="zeros", dtype=f32),
        "out": nn.linear_init(pf, (H, K), (D,), ("heads", "head_dim"), ("embed",), scale=out_scale),
    }


def channel_mix_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    return {
        "mu_k": pf.param((D,), ("embed",), init="zeros"),
        "mu_r": pf.param((D,), ("embed",), init="zeros"),
        "wk": nn.linear_init(pf, (D,), (Fd,), ("embed",), ("mlp",)),
        "wv": nn.linear_init(pf, (Fd,), (D,), ("mlp",), ("embed",), scale=out_scale),
        "wr": nn.linear_init(pf, (D,), (D,), ("embed",), ("embed_out",)),
    }


def _shifted(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the cached last token, at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent token-shift interpolation, one mix per target; the
    LoRA runs in f32."""
    dx = sx - x
    xx = x + dx * p["mu_base"].to(x.dtype)
    if is_dtensor(xx):  # the same products as nn.linear's, which a mesh can split
        lo = torch.tanh(nn.linear({"w": p["mix_w1"].float()}, xx.float()))
        w2 = p["mix_w2"].float()
        delta = torch.stack([nn.linear({"w": w2[i]}, lo[:, :, i]) for i in range(len(_TARGETS))],
                            dim=2)
    else:
        lo = torch.tanh(torch.einsum("bsd,dnr->bsnr", xx.float(), p["mix_w1"].float()))
        delta = torch.einsum("bsnr,nrd->bsnd", lo, p["mix_w2"].float())  # (B, S, n, D)
    return [x + dx * (p["mu"][i].float() + delta[:, :, i]).to(x.dtype)
            for i in range(len(_TARGETS))]


def time_mix_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str = "full",
    cache: Optional[Cache] = None,
) -> tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, D) -> (y (B, S, D), cache written in place, or None)."""
    B, S, _ = x.shape
    H, K = _dims(cfg)
    sx = _shifted(x, cache["shift"][:, None] if cache is not None else None)
    xr, xk, xv, xw, xg = _ddlerp(p, x, sx)

    r = nn.linear(p["recv"], xr)  # (B, S, H, K)
    k = nn.linear(p["key"], xk)
    v = nn.linear(p["value"], xv)
    g = nn.linear(p["gate"], xg)
    lw = torch.tanh(xw.float() @ p["decay_w1"].float())
    if is_dtensor(lw):
        lw = nn.linear({"w": p["decay_w2"].float()}, lw)
    else:
        lw = torch.einsum("bsr,rhk->bshk", lw, p["decay_w2"].float())
    w = torch.exp(-torch.exp(p["w0"][None, None] + lw))  # (B, S, H, K) in (0, 1)

    state0 = (cache["wkv"].float() if cache is not None
              else torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device))
    if mode == "full":
        out, state = ops.rwkv6_scan(r, k, v, w.float(), p["u"], state0, chunk=cfg.rwkv.chunk)
    elif mode == "decode" and S == 1:
        out, state = ops.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0].to(r.dtype), p["u"],
                                    state0)
        out = out[:, None]
    else:
        raise ValueError(f"time_mix_apply: mode={mode!r} S={S}")

    # per-head group norm (population variance, eps 64e-5), then gate and project
    of = out.float()
    mean = of.mean(dim=-1, keepdim=True)
    var = of.var(dim=-1, keepdim=True, correction=0)
    of = (of - mean) * torch.rsqrt(var + 64e-5) * p["ln_scale"] + p["ln_bias"]
    y = of.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    y = nn.linear(p["out"], y, n_in=2)
    if cache is not None:
        cache["shift"].copy_(x[:, -1])
        cache["wkv"].copy_(state)
    return y, cache


def channel_mix_apply(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: Optional[Cache] = None
) -> tuple[torch.Tensor, Optional[Cache]]:
    """Squared-ReLU key, sigmoid receptance; x: (B, S, D) -> (B, S, D)."""
    sx = _shifted(x, cache["shift"][:, None] if cache is not None else None)
    dx = sx - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(nn.linear(p["wk"], xk).float()))
    y = torch.sigmoid(nn.linear(p["wr"], xr).float()) * nn.linear(p["wv"], kk.to(x.dtype)).float()
    if cache is not None:
        cache["shift"].copy_(x[:, -1])
    return y.to(x.dtype), cache


def init_time_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device: torch.device) -> Cache:
    H, K = _dims(cfg)
    return {
        "shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
    }


def init_channel_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                       device: torch.device) -> Cache:
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
