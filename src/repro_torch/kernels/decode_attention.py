"""Decode attention (kernel K2): CUDA C++ for Hopper, ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``): one query token per sequence
against a KV cache whose slots carry absolute positions (``pos_ids``, -1 =
empty), so full caches and sliding-window ring buffers share one mask.

What bounds it on the card: reading the cache, once per token, is all the
work; the products are ~1 FLOP per byte, so what counts is blocks and bytes
in flight.  One call launches two kernels (counted once):

1. the split pass: the cache is split into ``n_split`` slot ranges
   (:func:`split_plan`, from the shapes and the SM count alone, so the call
   has fixed shapes and no host sync); a block per (range, KV head, batch
   row) reads its tiles once for all G query rows, through ``cp.async``
   rings, skips tiles without a live slot, and writes f32 partials
   (acc, m, l) to scratch from ``torch.empty``.  bf16 at D >= 16 runs
   ``decode_split_mma`` (the G rows padded to 16 as one ``mma.sync``
   operand, P rounded to bf16); f32, and bf16 at D 8, run
   ``decode_split_kernel`` on the CUDA cores (:func:`instances`);
2. ``decode_combine_kernel``: merges the partials per query row in a fixed
   order (``ref.decode_attention_split_ref`` is the same arithmetic).

A row with no live slot returns zeros, as the Pallas kernel does; the plain
version returns the mean of V there.  A CPU tensor takes the plain version,
:func:`plain` (``ref.decode_attention_ref``); a CUDA tensor launches the
kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import decode_attention_ref as plain

HEAD_DIMS = (8, 16, 32, 64, 128)  # the instances csrc/decode_attention.cu builds
MAX_GROUP = 16  # query heads per KV head (kMaxG in the source)
TILE = 32  # cache slots per tile (kTile in the source); a split is whole tiles
WAVES = 2  # blocks to aim for, in multiples of the SM count


def split_plan(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """``(n_split, chunk)``: split each (batch row, KV head)'s S slots into
    ``n_split`` ranges of ``chunk`` slots (the last one shorter), ``chunk`` a
    multiple of TILE, so that ``B * Hkv * n_split >= WAVES * n_sm`` where S
    has enough tiles for it."""
    tiles = -(-S // TILE)
    want = -(-WAVES * n_sm // (B * Hkv))
    per = max(1, tiles // want)  # tiles per range
    return -(-tiles // per), per * TILE


def instances(dtype: torch.dtype, head_dim: int) -> tuple[str, str]:
    """The two kernels a call runs, a function of dtype and head dim only:
    the split pass (bf16 at D >= 16 on the tensor cores, otherwise on the
    CUDA cores) and the combine."""
    split = ("decode_split_mma" if dtype == torch.bfloat16 and head_dim >= 16
             else "decode_split_kernel")
    return split, "decode_combine_kernel"


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_ids: torch.Tensor,
    cur_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); pos_ids: (B, S) int32;
    cur_pos: (B,) int32 -> (B, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, pos_ids, cur_pos, window=window,
                     softcap=softcap, scale=scale)
    refuse_grad("decode_attention", "decode is serving-only, as in the JAX package", q, k_cache,
                v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if pos_ids.shape != (B, S) or cur_pos.shape != (B,):
        raise ValueError(f"decode_attention: pos_ids {tuple(pos_ids.shape)} "
                         f"cur_pos {tuple(cur_pos.shape)} for B={B} S={S}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: Hq={Hq} Hkv={Hkv} D={D} unsupported "
                         f"(need Hq % Hkv == 0, Hq/Hkv <= {MAX_GROUP}, D in {HEAD_DIMS})")
    if q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype} {k_cache.dtype} {v_cache.dtype}")
    if pos_ids.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise ValueError(f"decode_attention: pos_ids / cur_pos must be int32, "
                         f"got {pos_ids.dtype} {cur_pos.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos_ids", pos_ids), ("cur_pos", cur_pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must start on a 16-byte boundary")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev_index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    n_split, chunk = split_plan(B, Hkv, S, _build.sm_count(dev_index))
    out = torch.empty_like(q)
    # acc (B, Hkv, n_split, G, D), then m and l (B, Hkv, n_split, G)
    partials = torch.empty(B * Hq * n_split * (D + 2), dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_ids.data_ptr(),
             cur_pos.data_ptr(), out.data_ptr(), partials.data_ptr(),
             _build.DTYPE_CODES[q.dtype], B, S, Hq, Hkv, D,
             -1 if window is None else int(window), float(softcap or 0.0), float(scale),
             n_split, chunk, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
