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
                       token per sequence (decode); with ``return_aux``
                       also the MoE layers' summed aux losses.
  * ``loss_fn``      — token-chunked next-token cross-entropy + z-loss +
                       the aux losses (training).
  * ``prefill``      — forward + KV cache construction + last-pos logits.
  * ``decode_step``  — one token per sequence against the caches.

Without caches (training), each period runs under
``torch.utils.checkpoint`` as ``cfg.remat_policy`` says, as the JAX model's
``jax.checkpoint`` around its scan body: ``nothing`` keeps only the
period's inputs and recomputes the rest in the backward, ``dots`` keeps the
matmul outputs too (selective checkpointing), ``everything`` is no remat.
The checkpoints stash no RNG state (``preserve_rng_state=False``): the
forward draws no random numbers, and reading the card's RNG state is
refused inside a CUDA graph's capture (``training/compiled.py``).

Named scopes (``core/scopes.py``) sit where the JAX model has its
``jax.named_scope``s: ``embed``, ``head{i}`` / ``tail{i}``,
``pos{i}_{mixer}_{ffn}``, ``mixer_{mixer}``, ``ffn_{ffn}`` and
``final_norm``.  Static tracepoints (``core/tracepoints.py``) fire at the
JAX sites: ``lm.embed_out``, ``lm.stack_out``, ``lm.loss``,
``lm.prefill_logits`` and ``lm.decode_logits``.  Disabled, neither
dispatches an op.

The ``vlm_stub`` (chameleon-34b) and ``audio_stub`` (musicgen-large)
frontends take precomputed (B, S, d_model) embeddings, ``frontend_embed``,
through ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``: projected
(``nn/frontend.py``) and added to the token embeddings under ``embed``.
Without them these archs run on tokens alone, as the serving engine runs
every arch (the JAX engine passes no embeddings either).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import tracepoints as tp
from repro_torch.core.scopes import scope
from repro_torch.distributed.constrain import constrain, is_dtensor, place, reduce_partials
from repro_torch.nn import attention as attn
from repro_torch.nn import core as nn
from repro_torch.nn import ffn as ffn_mod
from repro_torch.nn import frontend as frontend_mod
from repro_torch.nn import mamba as mamba_mod
from repro_torch.nn import rwkv as rwkv_mod


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _check_supported(spec: LayerSpec) -> None:
    if spec.ffn not in ("dense", "moe", "rwkv_ffn", "none"):
        raise ValueError(spec.ffn)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _block_init(pf: nn.ParamFactory, cfg: ModelConfig, spec: LayerSpec) -> dict:
    _check_supported(spec)
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
    if cfg.frontend != "text":
        p["frontend"] = frontend_mod.frontend_init(pf, cfg)
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
        # the meta device (shapes only, e.g. core/roofline.py) draws nothing:
        # a CPU generator stands in
        gen_device = "cpu" if device.type == "meta" else device
        generator = torch.Generator(device=gen_device).manual_seed(generator)
    return build_params(cfg, nn.ParamFactory(generator, torch_dtype(cfg.param_dtype), device))


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, as comma-joined strings in the
    params' tree (``nn.AxesFactory``); ``distributed/sharding.py`` maps
    them onto a mesh."""
    return build_params(cfg, nn.AxesFactory())


def abstract_params(cfg: ModelConfig) -> dict:
    """The params on the ``meta`` device: shapes and dtypes, no memory."""
    return init_params(cfg, 0, "meta")


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every cache leaf, in the tree of
    :func:`init_caches` (the JAX package's ``cache_axes``)."""
    A = nn.axes_str

    def block_axes(spec: LayerSpec) -> dict:
        if spec.mixer == "rwkv":
            c = {"mixer": {"shift": A(("batch", "embed")),
                           "wkv": A(("batch", "heads", "head_dim", "head_dim"))}}
        elif spec.mixer == "mamba":
            c = {"mixer": {"conv": A(("batch", None, "mlp")), "ssm": A(("batch", "mlp", None))}}
        else:
            kv = A(("batch", "cache_seq", "kv_heads", "head_dim"))
            c = {"mixer": {"k": kv, "v": kv, "pos_ids": A(("batch", "cache_seq"))}}
        if spec.ffn == "rwkv_ffn":
            c["ffn"] = {"shift": A(("batch", "embed"))}
        return c

    axes: dict = {name: block_axes(spec) for name, spec in _unscanned_layers(cfg)}
    if cfg.n_periods > 0:
        axes["blocks"] = {f"pos{pos}": _map(lambda a: "layers," + a, block_axes(spec))
                          for pos, spec in enumerate(cfg.layer_pattern)}
    return axes


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _block_cache(cfg, spec, batch, max_seq, dtype, device) -> dict:
    """A block's decode state: the KV cache of an attention mixer, the conv
    window and f32 SSM state of a Mamba mixer, or the shift vectors and f32
    WKV state of an RWKV block."""
    _check_supported(spec)
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
) -> tuple[torch.Tensor, Optional[dict]]:
    """One block -> (x, its MoE aux losses, or None for a block without
    MoE); its cache (if any) is updated in place."""
    moe_aux = None
    h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    with scope(f"mixer_{spec.mixer}"):
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
        with scope(f"ffn_{spec.ffn}"):
            if spec.ffn == "moe":
                h, moe_aux = ffn_mod.moe_apply(p["ffn"], h, cfg)
            elif spec.ffn == "rwkv_ffn":
                h, _ = rwkv_mod.channel_mix_apply(p["ffn"], h, cfg,
                                                  cache=cache.get("ffn") if cache else None)
            else:
                h = ffn_mod.ffn_apply(p["ffn"], h, cfg)
        if "norm2_post" in p:
            h = nn.rmsnorm(p["norm2_post"], h, cfg.norm_eps)
        x = x + h
    return x, moe_aux


# matmul outputs that remat_policy "dots" keeps: dot products without batch
# dims, as jax.checkpoint_policies.dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` run as ``remat_policy`` says (see the module docstring)."""
    if policy == "everything":
        return fn
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {policy!r} not in (nothing, dots, everything)")
    context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts, _keep_dots)
                  if policy == "dots" else ckpt.noop_context_fn)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=context_fn,
                             preserve_rng_state=False)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    frontend_embed: Optional[torch.Tensor] = None,
    *,
    mode: str = "full",
    caches: Optional[dict] = None,
    return_aux: bool = False,
):
    """tokens: (B, S) -> (hidden (B, S, D), caches), or with ``return_aux``
    (hidden, aux, caches), aux the f32 sum of the MoE layers' aux losses.
    ``frontend_embed`` (B, S, D), for an arch with a frontend, is projected
    and added to the token embeddings.

    ``caches`` are filled (prefill) or advanced (decode) in place and
    returned; ``None`` when none were given.
    """
    B, S = tokens.shape
    device = tokens.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    with scope("embed"):
        x = reduce_partials(nn.embed(params["embed"], tokens, scale_by_dim=cfg.scale_embedding))
        x = x.to(torch_dtype(cfg.activation_dtype))
        if cfg.frontend != "text" and frontend_embed is not None:
            x = x + frontend_mod.frontend_apply(params["frontend"], frontend_embed.to(x.dtype))
    tp.point("lm.embed_out", x)
    # the MoE aux losses are summed only when asked for: serving runs no
    # extra kernel for them
    aux = torch.zeros((), dtype=torch.float32, device=device) if return_aux else None

    def block(name: str, p: dict, spec: LayerSpec, x, aux, cache: Optional[dict]):
        with scope(name):
            x, moe_aux = _block_apply(p, x, cfg, spec, positions, mode=mode, cache=cache)
        if aux is not None and moe_aux is not None:
            aux = aux + moe_aux["moe_load_balance"] + moe_aux["moe_z_loss"]
        return x, aux

    unscanned = _unscanned_layers(cfg)
    for name, spec in unscanned:
        if name.startswith("head"):
            x, aux = block(name, params[name], spec, x, aux, caches[name] if caches else None)
    if cfg.n_periods > 0:
        n, pattern = cfg.n_periods, list(enumerate(cfg.layer_pattern))
        p_views = {pos: _periods(params["blocks"][f"pos{pos}"], n) for pos, _ in pattern}
        c_views = {pos: _periods(caches["blocks"][f"pos{pos}"], n) if caches else [None] * n
                   for pos, _ in pattern}

        def period(i: int, x, aux):
            for pos, spec in pattern:
                x, aux = block(f"pos{pos}_{spec.mixer}_{spec.ffn}", p_views[pos][i], spec, x,
                               aux, c_views[pos][i])
            return x, aux

        if caches is None:  # a cache written in place must not be written twice
            period = _remat(period, cfg.remat_policy)
        for i in range(n):
            x, aux = period(i, x, aux)
    for name, spec in unscanned:
        if name.startswith("tail"):
            x, aux = block(name, params[name], spec, x, aux, caches[name] if caches else None)

    tp.point("lm.stack_out", x)
    with scope("final_norm"):
        x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x, aux, caches) if return_aux else (x, caches)


def _batch_shards(x: torch.Tensor) -> int:
    """Devices the leading (batch) dim of a DTensor is split over; 1 for a
    plain tensor."""
    if not is_dtensor(x):
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == 0:
            n *= x.device_mesh.size(i)
    return n


def _logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    return nn.softcap(nn.unembed(table, hidden), cfg.final_logit_softcap)  # f32


# ---------------------------------------------------------------------------
# Loss (token-chunked cross-entropy)
# ---------------------------------------------------------------------------


def loss_fn(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
    frontend_embed: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross-entropy over all positions -> (loss, {ce, z_loss,
    aux, tokens}), loss = ce + z_loss + aux, all f32.

    The logits are never whole: the B x S tokens run in chunks of
    ``cfg.loss_chunk`` (one chunk of all of them when that does not divide
    B x S, as in the JAX package), each under ``torch.utils.checkpoint``, so
    a chunk's (chunk, V) f32 logits live only while it is computed, as
    ``jax.checkpoint`` keeps them in the JAX loss.  On a mesh whose devices
    split the batch rows, a chunk is instead the same number of positions
    of every row, so each device's chunk is its own rows' tokens.
    """
    hidden, aux, _ = forward(params, cfg, tokens, frontend_embed=frontend_embed, return_aux=True)
    B, S, D = hidden.shape
    T = B * S
    chunk = min(cfg.loss_chunk, T)
    if T % chunk:
        chunk = T
    table = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    if cfg.loss_table_replicated:
        # the data (FSDP) shard of the table's embed dim would make every
        # chunk's logits a partial sum; one gather of the table instead
        table = {"table": constrain(table["table"], "vocab", None)}

    def chunk_loss(h_c, y_c):
        logits = nn.softcap(nn.unembed(table, h_c), cfg.final_logit_softcap)  # (chunk, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = reduce_partials(logits.gather(-1, y_c[..., None]))[..., 0]
        return (lse - gold).sum(), lse.square().sum() * cfg.z_loss_weight

    nll_sum = z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_chunks = T // chunk
    if _batch_shards(hidden) > 1 and S % n_chunks == 0:
        # Rows sharded over devices: a chunk of the flat token axis would
        # gather rows across them, so each chunk is S / n_chunks positions
        # of every row instead (the same tokens a device, its own rows).
        parts = [(hidden[:, s0:s0 + S // n_chunks], labels[:, s0:s0 + S // n_chunks].long())
                 for s0 in range(0, S, S // n_chunks)]
    else:
        h, y = hidden.reshape(T, D), labels.reshape(T).long()
        parts = [(h[c0:c0 + chunk], y[c0:c0 + chunk]) for c0 in range(0, T, chunk)]
    for h_c, y_c in parts:
        nll, zl = ckpt.checkpoint(chunk_loss, h_c, y_c, use_reentrant=False,
                                  preserve_rng_state=False)
        nll_sum, z_sum = nll_sum + nll, z_sum + zl
    ce, z = nll_sum / T, z_sum / T
    loss = ce + z + aux
    tp.point("lm.loss", loss)
    return loss, {"ce": ce, "z_loss": z, "aux": aux,
                  "tokens": torch.full((), float(T), device=hidden.device)}


# ---------------------------------------------------------------------------
# Serving surfaces
# ---------------------------------------------------------------------------


def prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    frontend_embed: Optional[torch.Tensor] = None,
    *,
    max_seq: Optional[int] = None,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V) f32, caches)."""
    B, S = tokens.shape
    caches = init_caches(cfg, B, max_seq or S, tokens.device)
    if is_dtensor(tokens):  # a sharded step: its caches live on the mesh too
        caches = place(caches, cache_axes(cfg), tokens.device_mesh)
    hidden, caches = forward(params, cfg, tokens, frontend_embed=frontend_embed, mode="full",
                             caches=caches)
    logits = _logits(params, cfg, hidden[:, -1])
    tp.point("lm.prefill_logits", logits)
    return logits, caches


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cur_pos: torch.Tensor,
    caches: dict,
    frontend_embed: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) new token ids; cur_pos: (B,) absolute positions;
    frontend_embed: (B, 1, D) or None.

    Returns (logits (B, V) f32, caches), the caches advanced in place.
    """
    positions = cur_pos[:, None].to(torch.int32)
    hidden, caches = forward(params, cfg, tokens[:, None], positions, frontend_embed,
                             mode="decode", caches=caches)
    logits = _logits(params, cfg, hidden[:, -1])
    tp.point("lm.decode_logits", logits)
    return logits, caches
