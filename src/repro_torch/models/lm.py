"""Decoder-only LM over a per-layer pattern spec: attention or Mamba mixers
with dense or MoE FFNs, and RWKV6 time mix with its channel mix.

Counterpart of ``repro/models/lm.py``.  Parameters and caches keep the JAX
package's tree: layers outside whole periods live under ``head{i}`` /
``tail{i}``, and each pattern position's layers are stacked over the periods
under ``blocks/pos{i}`` with a leading ``n_periods`` axis.  Where the JAX
model ``lax.scan``s over that axis, the port runs a Python loop over views
of it, so caches are written in place.

Surfaces:
  * ``forward``      — hidden states for a full sequence (prefill) or one
                       token per sequence (decode).
  * ``prefill``      — forward + KV cache construction + last-pos logits.
  * ``decode_step``  — one token per sequence against the caches.

The vlm/audio frontends raise ``NotImplementedError`` (ROADMAP item M10);
the training loss, which reads the MoE layers' aux losses, is M9, so
serving discards them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import core as nn
from repro_torch.nn import ffn as ffn_mod
from repro_torch.nn import mamba as mamba_mod
from repro_torch.nn import rwkv as rwkv_mod


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _check_supported(cfg: ModelConfig, spec: LayerSpec) -> None:
    if cfg.frontend != "text":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is ROADMAP item M10")
    if spec.ffn not in ("dense", "moe", "rwkv_ffn", "none"):
        raise NotImplementedError(f"ffn {spec.ffn!r} is ROADMAP item M10")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _block_init(pf: nn.ParamFactory, cfg: ModelConfig, spec: LayerSpec) -> dict:
    _check_supported(cfg, spec)
    p: dict = {"norm1": nn.rmsnorm_init(pf, cfg.d_model)}
    init = {"rwkv": rwkv_mod.time_mix_init, "mamba": mamba_mod.mamba_init}
    p["mixer"] = init.get(spec.mixer, attn.attention_init)(pf, cfg)
    if cfg.post_block_norms:
        p["norm1_post"] = nn.rmsnorm_init(pf, cfg.d_model)
    if spec.ffn != "none":
        p["norm2"] = nn.rmsnorm_init(pf, cfg.d_model)
        init = {"moe": ffn_mod.moe_init, "rwkv_ffn": rwkv_mod.channel_mix_init}
        p["ffn"] = init.get(spec.ffn, ffn_mod.ffn_init)(pf, cfg)
        if cfg.post_block_norms:
            p["norm2_post"] = nn.rmsnorm_init(pf, cfg.d_model)
    return p


def _unscanned_layers(cfg: ModelConfig) -> list[tuple[str, LayerSpec]]:
    """(name, spec) for layers outside the stacked periods."""
    out = [(f"head{i}", cfg.layer_spec(i)) for i in range(cfg.first_k_dense)]
    tail_start = cfg.first_k_dense + cfg.n_periods * cfg.period
    out += [(f"tail{i}", cfg.layer_spec(i)) for i in range(tail_start, cfg.n_layers)]
    return out


def build_params(cfg: ModelConfig, pf: nn.ParamFactory) -> dict:
    p: dict = {"embed": nn.embedding_init(pf, cfg.vocab_size, cfg.d_model)}
    for name, spec in _unscanned_layers(cfg):
        p[name] = _block_init(pf, cfg, spec)
    if cfg.n_periods > 0:
        p["blocks"] = {}
        for pos, spec in enumerate(cfg.layer_pattern):
            with pf.stacked(cfg.n_periods):
                p["blocks"][f"pos{pos}"] = _block_init(pf, cfg, spec)
    p["final_norm"] = nn.rmsnorm_init(pf, cfg.d_model)
    if not cfg.tied_embeddings:
        p["lm_head"] = nn.embedding_init(pf, cfg.vocab_size, cfg.d_model)
    return p


def init_params(
    cfg: ModelConfig, generator: torch.Generator | int = 0, device: str | torch.device = "cuda"
) -> dict:
    """Random weights under the JAX package's init laws, drawn from a
    ``torch.Generator`` on ``device`` (or a fresh one seeded with an int).
    ``cuda`` without a card raises."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    return build_params(cfg, nn.ParamFactory(generator, torch_dtype(cfg.param_dtype), device))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _block_cache(cfg, spec, batch, max_seq, dtype, device) -> dict:
    """A block's decode state: the KV cache of an attention mixer, the conv
    window and f32 SSM state of a Mamba mixer, or the shift vectors and f32
    WKV state of an RWKV block."""
    _check_supported(cfg, spec)
    if spec.mixer == "rwkv":
        c = {"mixer": rwkv_mod.init_time_cache(cfg, batch, dtype, device)}
    elif spec.mixer == "mamba":
        c = {"mixer": mamba_mod.init_cache(cfg, batch, dtype, device)}
    else:
        c = {"mixer": attn.init_cache(cfg, spec.mixer, batch, max_seq, dtype, device)}
    if spec.ffn == "rwkv_ffn":
        c["ffn"] = rwkv_mod.init_channel_cache(cfg, batch, dtype, device)
    return c


def init_caches(
    cfg: ModelConfig, batch: int, max_seq: int, device: str | torch.device = "cuda"
) -> dict:
    dtype, device = torch_dtype(cfg.activation_dtype), resolve_device(device)
    caches: dict = {}
    for name, spec in _unscanned_layers(cfg):
        caches[name] = _block_cache(cfg, spec, batch, max_seq, dtype, device)
    if cfg.n_periods > 0:
        caches["blocks"] = {}
        for pos, spec in enumerate(cfg.layer_pattern):
            one = _block_cache(cfg, spec, batch, max_seq, dtype, device)
            caches["blocks"][f"pos{pos}"] = _map(
                lambda x: x[None].repeat((cfg.n_periods,) + (1,) * x.dim()), one
            )
    return caches


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _periods(tree, n: int) -> list:
    """The ``n`` periods of a stacked tree, one ``unbind`` per leaf: views,
    so writes reach the stack."""
    if isinstance(tree, dict):
        subs = {k: _periods(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _block_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: LayerSpec,
    positions: torch.Tensor,
    *,
    mode: str,
    cache: Optional[dict],
) -> torch.Tensor:
    """One block; its cache (if any) is updated in place.  An MoE block's
    aux losses are discarded (serving)."""
    h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    if spec.mixer == "rwkv":
        h, _ = rwkv_mod.time_mix_apply(p["mixer"], h, cfg, mode=mode, cache=mixer_cache)
    elif spec.mixer == "mamba":
        h, _ = mamba_mod.mamba_apply(p["mixer"], h, cfg, mode=mode, cache=mixer_cache)
    else:
        h, _ = attn.attention_apply(p["mixer"], h, cfg, spec.mixer, positions, mode=mode,
                                    cache=mixer_cache)
    if "norm1_post" in p:
        h = nn.rmsnorm(p["norm1_post"], h, cfg.norm_eps)
    x = x + h
    if spec.ffn != "none":
        h = nn.rmsnorm(p["norm2"], x, cfg.norm_eps)
        if spec.ffn == "moe":
            h, _ = ffn_mod.moe_apply(p["ffn"], h, cfg)
        elif spec.ffn == "rwkv_ffn":
            h, _ = rwkv_mod.channel_mix_apply(p["ffn"], h, cfg,
                                              cache=cache.get("ffn") if cache else None)
        else:
            h = ffn_mod.ffn_apply(p["ffn"], h, cfg)
        if "norm2_post" in p:
            h = nn.rmsnorm(p["norm2_post"], h, cfg.norm_eps)
        x = x + h
    return x


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    *,
    mode: str = "full",
    caches: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """tokens: (B, S) -> (hidden (B, S, D), caches).

    ``caches`` are filled (prefill) or advanced (decode) in place and
    returned; ``None`` when none were given.
    """
    B, S = tokens.shape
    device = tokens.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    x = nn.embed(params["embed"], tokens, scale_by_dim=cfg.scale_embedding)
    x = x.to(torch_dtype(cfg.activation_dtype))

    def run(p: dict, spec: LayerSpec, cache: Optional[dict]) -> None:
        nonlocal x
        x = _block_apply(p, x, cfg, spec, positions, mode=mode, cache=cache)

    unscanned = _unscanned_layers(cfg)
    for name, spec in unscanned:
        if name.startswith("head"):
            run(params[name], spec, caches[name] if caches else None)
    if cfg.n_periods > 0:
        n, pattern = cfg.n_periods, list(enumerate(cfg.layer_pattern))
        p_views = {pos: _periods(params["blocks"][f"pos{pos}"], n) for pos, _ in pattern}
        c_views = {pos: _periods(caches["blocks"][f"pos{pos}"], n) if caches else [None] * n
                   for pos, _ in pattern}
        for i in range(n):
            for pos, spec in pattern:
                run(p_views[pos][i], spec, c_views[pos][i])
    for name, spec in unscanned:
        if name.startswith("tail"):
            run(params[name], spec, caches[name] if caches else None)

    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def _logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    return nn.softcap(nn.unembed(table, hidden), cfg.final_logit_softcap)  # f32


# ---------------------------------------------------------------------------
# Serving surfaces
# ---------------------------------------------------------------------------


def prefill(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, max_seq: Optional[int] = None
) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V) f32, caches)."""
    B, S = tokens.shape
    caches = init_caches(cfg, B, max_seq or S, tokens.device)
    hidden, caches = forward(params, cfg, tokens, mode="full", caches=caches)
    return _logits(params, cfg, hidden[:, -1]), caches


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cur_pos: torch.Tensor,
    caches: dict,
) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) new token ids; cur_pos: (B,) absolute positions.

    Returns (logits (B, V) f32, caches), the caches advanced in place.
    """
    positions = cur_pos[:, None].to(torch.int32)
    hidden, caches = forward(params, cfg, tokens[:, None], positions, mode="decode",
                             caches=caches)
    return _logits(params, cfg, hidden[:, -1]), caches
