"""Plain PyTorch versions of the ported kernels (counterpart of
``repro/kernels/ref.py``).

Each is the simplest correct implementation, materialising the full score
matrix.  The CPU path of every kernel wrapper runs them, the CPU tests hold
them against the JAX package, and ``chip_smoke.py`` holds each CUDA/Triton
kernel against them on the card.

Shape conventions:
  attention   q: (B, Sq, Hq, D);  k, v: (B, Skv, Hkv, D);  Hq % Hkv == 0
  decode      q: (B, Hq, D);      cache: (B, S, Hkv, D);   pos_ids: (B, S)
  gmm         x: (E, C, D);       w: (E, D, F)
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # large-finite: avoids NaN from (-inf) - (-inf) in fully-masked rows


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def mha_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-materialisation attention (GQA/causal/SWA/softcap), f32 math."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qr = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_ids: torch.Tensor,
    cur_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    return_stats: bool = False,
):
    """Single-step attention against a (possibly ring-buffer) KV cache.

    pos_ids[b, s] is the absolute position stored in cache slot s (-1 = empty),
    which uniformly handles full caches and SWA ring buffers.  cur_pos: (B,).

    ``return_stats``: return the flash-decoding partials ``(acc, m, l)`` with
    out = acc / l, the combinable form for split-KV.
    """
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qr = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float())
    s = _softcap(s, softcap)
    cur = cur_pos[:, None]
    ok = (pos_ids >= 0) & (pos_ids <= cur)
    if window is not None:
        ok &= pos_ids > cur - window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)  # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    if return_stats:
        return acc, m, l
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


# Epilogues of the grouped matmul, applied to its f32 accumulator: the
# gated-FFN activations (gelu in its tanh form, as in the JAX package).
EPILOGUES = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def gmm_ref(x: torch.Tensor, w: torch.Tensor, epilogue: Optional[str] = None) -> torch.Tensor:
    """(E, C, D) @ (E, D, F) -> (E, C, F): f32 products and accumulation, the
    optional epilogue on the f32 result, one rounding to x's dtype."""
    acc = torch.bmm(x.float(), w.float())
    if epilogue is not None:
        acc = EPILOGUES[epilogue](acc)
    return acc.to(x.dtype)


def moe_ffn_ref(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, act: str = "silu"
) -> torch.Tensor:
    """Per-expert gated FFN: act(x@w1) * (x@w3) @ w2.  The activation acts on
    the product rounded to x's dtype, and the gate product is taken in f32,
    as ``repro/kernels/ref.py::moe_ffn_ref`` does."""
    h = EPILOGUES[act](gmm_ref(x, w1).float()) * gmm_ref(x, w3).float()
    return gmm_ref(h.to(x.dtype), w2)
