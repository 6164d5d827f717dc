"""GQA attention block: global / sliding-window, softcap, QK-norm, QKV bias.

Counterpart of ``repro/nn/attention.py``, with two modes:

* ``full``   — prefill over a whole sequence (``ops.attention``: the flash
  kernel on the card), optionally filling a KV cache;
* ``decode`` — one new token against a KV cache (full or SWA ring buffer),
  through ``ops.decode_attention``.

Cache contract (uniform for full and ring caches): ``pos_ids[b, s]`` is the
absolute position held in cache slot ``s`` (-1 = empty), and position ``p``
lives in slot ``p % size``.  Unlike the JAX package, which returns new cache
arrays, the port writes the cache tensors in place and returns the same
dict.

Sharding (``distributed/``): with ``activation_constraints`` the prefill's
q, k and v are constrained to ``(batch, seq, heads | kv_heads, head_dim)``
under the ambient mesh, as the JAX package constrains them (no mesh, or
plain tensors: a no-op).  ``decode_split_kv`` sends the decode step through
``ops.decode_attention_seq_sharded`` over ``cfg.decode_seq_axes`` when the
ambient mesh has them (K2's partials per cache shard, combined across the
devices); without a mesh it falls back to ``ops.decode_attention``.  A
cache held as DTensors is written shard by shard (:func:`_write_slots`).
``pad_heads_to`` pads GSPMD's head axis in the JAX package and is carried
with no effect here.  Every
head dim of the ported archs runs on the card, gemma3-4b's 256 included
(K1 and K2 have D-256 instances), with gemma2's softcap and the sliding
window of both gemmas.  QK-norm (chameleon-34b) normalises each query and
key head over its head_dim after the projections and before RoPE, through
the RMSNorm kernel (K3) over rows of head_dim.  The backward of attention
is always the flash backward (K1b), at every head dim K1 has (in bf16 at D
128 and 256 its tensor-core pair ``flash_bwd_dq_wide`` /
``flash_bwd_dkdv_wide``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constrain import constrain, is_dtensor
from repro_torch.kernels import ops
from repro_torch.nn import core as nn

Cache = dict[str, torch.Tensor]


def attention_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "q": nn.linear_init(pf, (D,), (Hq, hd), ("embed",), ("heads", "head_dim"),
                            bias=cfg.qkv_bias),
        "k": nn.linear_init(pf, (D,), (Hkv, hd), ("embed",), ("kv_heads", "head_dim"),
                            bias=cfg.qkv_bias),
        "v": nn.linear_init(pf, (D,), (Hkv, hd), ("embed",), ("kv_heads", "head_dim"),
                            bias=cfg.qkv_bias),
        "o": nn.linear_init(pf, (Hq, hd), (D,), ("heads", "head_dim"), ("embed",),
                            scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(pf, hd, "head_dim")
        p["k_norm"] = nn.rmsnorm_init(pf, hd, "head_dim")
    return p


def _window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    return cfg.sliding_window if mixer == "swa" else None


def init_cache(
    cfg: ModelConfig, mixer: str, batch: int, max_seq: int, dtype: torch.dtype,
    device: torch.device,
) -> Cache:
    """Full cache for global layers; ring buffer of `sliding_window` for SWA."""
    size = min(cfg.sliding_window, max_seq) if mixer == "swa" else max_seq
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos_ids": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def attention_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    mixer: str,
    positions: torch.Tensor,
    *,
    mode: str = "full",
    cache: Optional[Cache] = None,
) -> tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, D) for full; (B, 1, D) for decode.  positions: (B, S) / (B, 1)."""
    B, S, _ = x.shape
    window = _window(cfg, mixer)
    q = nn.linear(p["q"], x)  # (B, S, Hq, hd)
    k = nn.linear(p["k"], x)  # (B, S, Hkv, hd)
    v = nn.linear(p["v"], x)
    if cfg.qk_norm:
        # K3 over rows of hd: the projections' outputs are contiguous, so
        # (B, S, H, hd) is B x S x H rows as it stands, with no copy
        q = nn.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = nn.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)

    if mode == "full":
        if cfg.activation_constraints:
            q = constrain(q, "batch", "seq", "heads", "head_dim")
            k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
            v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
        out = ops.attention(q, k, v, causal=True, window=window,
                            softcap=cfg.attn_logit_softcap)
        new_cache = None
        if cache is not None:
            new_cache = _fill_cache_from_prefill(cache, k, v, positions)
        return nn.linear(p["o"], out, n_in=2), new_cache

    if mode != "decode" or cache is None or S != 1:
        raise ValueError(f"attention_apply: mode={mode!r} S={S} cache={cache is not None}")
    cur = positions[:, 0]  # (B,) int32
    size = cache["k"].shape[1]
    slot = (cur % size).long()
    if is_dtensor(cache["k"]):
        for name, val in (("k", k), ("v", v), ("pos_ids", positions)):
            _write_slots(cache[name], slot[:, None], val.to(cache[name].dtype))
    else:
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos_ids"][bidx, slot] = cur
    out = None
    if cfg.decode_split_kv:
        out = ops.decode_attention_seq_sharded(
            q[:, 0], cache["k"], cache["v"], cache["pos_ids"], cur, window=window,
            softcap=cfg.attn_logit_softcap, seq_axes=tuple(cfg.decode_seq_axes),
            batch_axes=tuple(cfg.decode_batch_axes))
    if out is None:
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], cache["pos_ids"], cur,
                                   window=window, softcap=cfg.attn_logit_softcap)
    return nn.linear(p["o"], out[:, None], n_in=2), cache


def _fill_cache_from_prefill(
    cache: Cache, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> Cache:
    """Write prefill K/V into a (possibly smaller ring) cache at slot = pos % size.

    A prefill's positions rise by one along each row, so only its last
    ``size`` columns survive in a ring, as in the JAX package; for a cache
    at least as long as the prompt that is all of them.  The kept range
    follows from the shapes alone, so the write needs no device-to-host
    sync.
    """
    B, S = positions.shape
    size = cache["k"].shape[1]
    keep = slice(max(0, S - size), S)
    pos = positions[:, keep]
    slots = (pos % size).long()
    if is_dtensor(cache["k"]):
        for name, val in (("k", k[:, keep]), ("v", v[:, keep]), ("pos_ids", pos)):
            _write_slots(cache[name], slots, val.to(cache[name].dtype))
        return cache
    bidx = torch.arange(B, device=positions.device)[:, None]
    cache["k"][bidx, slots] = k[:, keep].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, keep].to(cache["v"].dtype)
    cache["pos_ids"][bidx, slots] = pos.to(torch.int32)
    return cache


def _write_slots(buf: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor) -> None:
    """``buf[b, slots[b, j]] = vals[b, j]`` for a cache leaf held as a
    DTensor (``buf`` (B, size, ...), ``slots`` (B, n), ``vals`` (B, n,
    ...)), written on each rank's own shard: the rows of its batch shard,
    and of its slot range where the cache's sequence is sharded.  The JAX
    package leaves this scatter to GSPMD, which keeps it local; a DTensor
    ``index_put_`` has no such strategy.  ``vals`` and ``slots`` are
    redistributed to the cache's batch placement first (one gather of the
    (B, n)-sized values where they are sharded otherwise)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = buf.device_mesh, buf.placements
    seq_sharded = any(p.is_shard() and p.dim == 1 for p in pl)
    if seq_sharded and slots.shape[1] != 1:
        raise ValueError("a cache sharded over its sequence takes one slot a row a write")
    like_vals = [Replicate() if (p.is_shard() and p.dim == 1) else p for p in pl]
    rows = [p if (p.is_shard() and p.dim == 0) else Replicate() for p in pl]

    def local(t: torch.Tensor, want) -> torch.Tensor:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, want).to_local()

    lv, ls = local(vals, like_vals), local(slots, rows)
    lb = buf.to_local()
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    rel = ls - offset[1]
    bidx = torch.arange(lb.shape[0], device=lb.device)[:, None]
    if seq_sharded:  # only the shard holding the slot writes it
        inside = (rel >= 0) & (rel < shape[1])
        rel = rel.clamp(0, shape[1] - 1)
        cur = lb[bidx, rel]
        lv = torch.where(inside.reshape(inside.shape + (1,) * (lv.dim() - 2)), lv, cur)
    lb[bidx, rel] = lv
