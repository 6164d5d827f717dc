"""Mamba-1 block (Jamba variant: RMSNorm on Δ/B/C for stability).

Counterpart of ``repro/nn/mamba.py``.  Full-sequence mode runs the
selective scan (``ops.mamba_scan``: kernel K5 on the card); decode mode
keeps O(1) state per sequence: the last ``d_conv - 1`` raw (pre-conv)
inputs of the causal conv (``conv``) and the (d_inner, d_state) f32 SSM
state (``ssm``).  As in ``nn/attention.py``, the port writes the cache
tensors in place and returns the same dict.

The rounding points are the JAX module's: the full-mode conv is a sum of
``d_conv`` shifted products in x's dtype, silu runs in f32, dt is cast to
x's dtype before the scan, the decode conv is an f32 einsum over the
window, and the gate is ``y * silu(z in f32)`` cast to x's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constrain import is_dtensor
from repro_torch.kernels import ops
from repro_torch.nn import core as nn

Cache = dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, mc.d_state, mc.d_conv, dt_rank


def _a_log_init(shape: tuple[int, ...]) -> torch.Tensor:
    """S4D-real: A_log = log(1..N), broadcast over channels."""
    return torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32)).expand(shape)


def mamba_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    DI, N, DC, R = _dims(cfg)

    def dt_bias_init(shape: tuple[int, ...]) -> torch.Tensor:
        # softplus^-1(dt) for dt ~ LogUniform[1e-3, 1e-1] (Mamba init)
        u = torch.rand(shape, generator=pf.generator, dtype=torch.float32, device=pf.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))

    f32 = torch.float32
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    return {
        "in_proj": nn.linear_init(pf, (D,), (2 * DI,), ("embed",), ("mlp",)),
        "conv_w": pf.param((DC, DI), (None, "mlp"), scale=1.0 / math.sqrt(DC)),
        "conv_b": pf.param((DI,), ("mlp",), init="zeros"),
        "x_proj": nn.linear_init(pf, (DI,), (R + 2 * N,), ("mlp",), (None,)),
        "dt_proj": nn.linear_init(pf, (R,), (DI,), (None,), ("mlp",), scale=R**-0.5),
        "dt_bias": pf.param((DI,), ("mlp",), init=dt_bias_init, dtype=f32),
        "A_log": pf.param((DI, N), ("mlp", None), init=_a_log_init, dtype=f32),
        "D": pf.param((DI,), ("mlp",), init="ones", dtype=f32),
        "dt_norm": nn.rmsnorm_init(pf, R, None),
        "b_norm": nn.rmsnorm_init(pf, N, None),
        "c_norm": nn.rmsnorm_init(pf, N, None),
        "out_proj": nn.linear_init(pf, (DI,), (D,), ("mlp",), ("embed",), scale=out_scale),
    }


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device: torch.device) -> Cache:
    DI, N, DC, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, DC - 1, DI), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, DI, N), dtype=torch.float32, device=device),
    }


def _ssm_inputs(p: dict, xs: torch.Tensor, cfg: ModelConfig):
    """xs: (..., DI) -> dt (..., DI) f32, B, C (..., N) in xs's dtype."""
    _, N, _, R = _dims(cfg)
    dbc = nn.linear(p["x_proj"], xs)
    dt_r, b, c = (t.contiguous() for t in torch.split(dbc, [R, N, N], dim=-1))
    dt_r = nn.rmsnorm(p["dt_norm"], dt_r, cfg.norm_eps)
    b = nn.rmsnorm(p["b_norm"], b, cfg.norm_eps)
    c = nn.rmsnorm(p["c_norm"], c, cfg.norm_eps)
    # softplus as JAX's logaddexp(v, 0): F.softplus returns v itself above
    # its threshold of 20
    v = nn.linear(p["dt_proj"], dt_r).float() + p["dt_bias"]
    return torch.logaddexp(v, v.new_zeros(())), b, c


def mamba_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str = "full",
    cache: Optional[Cache] = None,
) -> tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, D) full / (B, 1, D) decode -> (y (B, S, D), cache written
    in place, or None)."""
    B, S, _ = x.shape
    DI, N, DC, _ = _dims(cfg)
    if mode == "full" and is_dtensor(x):
        return _mamba_full_sharded(p, x, cfg, cache), cache
    xs, z = nn.linear(p["in_proj"], x).chunk(2, dim=-1)  # (B, S, DI) each
    A = -torch.exp(p["A_log"])

    if mode == "full":
        # causal depthwise conv as DC shifted products, summed in x's dtype
        padded = F.pad(xs, (0, 0, DC - 1, 0))
        conv = sum(p["conv_w"][i] * padded[:, i:i + S] for i in range(DC)) + p["conv_b"]
        xs_c = F.silu(conv.float()).to(x.dtype)
        dt, b, c = _ssm_inputs(p, xs_c, cfg)
        state0 = torch.zeros((B, DI, N), dtype=torch.float32, device=x.device)
        y, state = ops.mamba_scan(xs_c, dt.to(x.dtype), A, b, c, p["D"], state0,
                                  chunk=cfg.mamba.chunk)
        if cache is not None:
            window = xs if S >= DC - 1 else torch.cat([cache["conv"], xs], 1)
            cache["conv"].copy_(window[:, -(DC - 1):])
            cache["ssm"].copy_(state)
    elif mode == "decode" and cache is not None and S == 1:
        window = torch.cat([cache["conv"], xs], 1)  # (B, DC, DI)
        conv = torch.einsum("bci,ci->bi", window.float(), p["conv_w"].float()) + p["conv_b"]
        xs_c = F.silu(conv).to(x.dtype)  # (B, DI)
        dt, b, c = _ssm_inputs(p, xs_c, cfg)
        y, state = ops.mamba_step(xs_c, dt.to(x.dtype), A, b, c, p["D"], cache["ssm"])
        y = y[:, None]
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(state)
    else:
        raise ValueError(f"mamba_apply: mode={mode!r} S={S} cache={cache is not None}")

    y = y * F.silu(z.float()).to(x.dtype)
    return nn.linear(p["out_proj"], y), cache



def _mamba_full_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        cache: Optional[Cache]) -> torch.Tensor:
    """:func:`mamba_apply`'s full-sequence mode on DTensors: the in- and
    out-projections as sharded products (``nn.linear``), and everything
    between (the split into xs and z, the causal conv, the SSM inputs, the
    scan, the gate) on each rank's rows, every channel of them: the input
    projection's output is gathered over the mesh dims that split its
    channels (splitting it into xs and z, padding and slicing it in time
    have no DTensor strategy that every torch version gets right).  A cache
    takes its conv window and final state shard by shard."""
    inner = {k: v for k, v in p.items() if k not in ("in_proj", "out_proj")}
    paths = [(k, j) for k, v in sorted(inner.items())
             for j in (sorted(v) if isinstance(v, dict) else [None])]
    DI, N, DC, _ = _dims(cfg)

    def body(xz: torch.Tensor, *flat: torch.Tensor):
        q: dict = {}
        for (k, j), t in zip(paths, flat):
            if j is None:
                q[k] = t
            else:
                q.setdefault(k, {})[j] = t
        xs, z = xz.chunk(2, dim=-1)
        S = xs.shape[1]
        padded = F.pad(xs, (0, 0, DC - 1, 0))
        conv = sum(q["conv_w"][i] * padded[:, i:i + S] for i in range(DC)) + q["conv_b"]
        xs_c = F.silu(conv.float()).to(xs.dtype)
        dt, b, c = _ssm_inputs(q, xs_c, cfg)
        state0 = torch.zeros((xs.shape[0], DI, N), dtype=torch.float32, device=xs.device)
        y, state = ops.mamba_scan(xs_c, dt.to(xs.dtype), -torch.exp(q["A_log"]), b, c, q["D"],
                                  state0, chunk=cfg.mamba.chunk)
        return y * F.silu(z.float()).to(xs.dtype), padded[:, -(DC - 1):], state

    flat = [(inner[k] if j is None else inner[k][j], {}) for k, j in paths]
    y, window, state = ops.on_shards(body, [(nn.linear(p["in_proj"], x), {0: 0})] + flat, {0: 0})
    if cache is not None:
        for name, new in (("conv", window), ("ssm", state)):
            dst = cache[name]
            dst.to_local().copy_(new.redistribute(dst.device_mesh, dst.placements).to_local())
    return nn.linear(p["out_proj"], y)
