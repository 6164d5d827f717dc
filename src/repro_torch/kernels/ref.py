"""Plain PyTorch versions of the ported kernels (counterpart of
``repro/kernels/ref.py``).

Each is the simplest correct implementation (the attention versions
materialise the full score matrix).  The CPU path of every kernel wrapper
runs them, the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Shape conventions:
  attention   q: (B, Sq, Hq, D);  k, v: (B, Skv, Hkv, D);  Hq % Hkv == 0
  decode      q: (B, Hq, D);      cache: (B, S, Hkv, D);   pos_ids: (B, S)
  gmm         x: (E, C, D);       w: (E, D, F)
  rwkv6 scan  r, k, w: (B, T, H, K);  v: (B, T, H, V);  u: (H, K);
              state: (B, H, K, V)
  mamba scan  x, dt: (B, T, DI);  A: (DI, N);  Bm, C: (B, T, N);  D: (DI,);
              state: (B, DI, N)
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


def decode_attention_split_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_ids: torch.Tensor,
    cur_pos: torch.Tensor,
    *,
    n_split: int,
    chunk: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Split-KV decode attention, the arithmetic of the K2 kernel's two
    passes: the S slots in ``n_split`` ranges of ``chunk`` (default
    ceil(S / n_split)) slots, the last one shorter; each range's partials
    ``decode_attention_ref(return_stats=True)``, with (0, NEG_INF, 0) for a
    range without a live slot; then per row m = max m_i and
    out = sum acc_i e^(m_i - m) / max(sum l_i e^(m_i - m), 1e-30), in range
    order.  A row with no live slot at all gives zeros, as the Pallas
    kernel does, where :func:`decode_attention_ref` gives the mean of V."""
    B, Hq, D = q.shape
    S = k_cache.shape[1]
    chunk = -(-S // n_split) if chunk is None else chunk
    if not (n_split - 1) * chunk < S <= n_split * chunk:
        raise ValueError(f"{n_split} ranges of {chunk} slots do not cover S={S} exactly once")
    parts = []
    for i in range(n_split):
        sl = slice(i * chunk, min(S, (i + 1) * chunk))
        acc, m, l = decode_attention_ref(q, k_cache[:, sl], v_cache[:, sl], pos_ids[:, sl],
                                         cur_pos, window=window, softcap=softcap, scale=scale,
                                         return_stats=True)
        p = pos_ids[:, sl]
        live = (p >= 0) & (p <= cur_pos[:, None])
        if window is not None:
            live &= p > cur_pos[:, None] - window
        dead = ~live.any(dim=1)[:, None, None]  # (B, 1, 1)
        parts.append((torch.where(dead[..., None], 0.0, acc), torch.where(dead, NEG_INF, m),
                      torch.where(dead, 0.0, l)))
    m_max = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][2])
    for acc, m, l in parts:
        w = torch.exp(m - m_max)
        num = num + acc * w[..., None]
        den = den + l * w
    out = num / torch.clamp(den, min=1e-30)[..., None]
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


# ---------------------------------------------------------------------------
# RWKV6 (Finch) WKV scan
# ---------------------------------------------------------------------------


def rwkv6_scan_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serial per-step recurrence, the oracle:

      out_t = r_t · (S_t + diag(u) k_t v_tᵀ);   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

    f32 math; returns (out (B, T, H, V) in r's dtype, state in its dtype).
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf, s = u.float(), state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf[None, :, :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1).to(r.dtype), s.to(state.dtype)


def rwkv6_scan_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked closed form of the same recurrence (the JAX package's
    production path).  Within a chunk of L steps, with cum = cumsum(log w):

      out_t = r_t·(P_t ⊙ S₀) + Σ_{s<t} r_t·(D_{ts} ⊙ k_s) v_s + (r_t·(u ⊙ k_t)) v_t
      D_{ts} = exp(cum_{t-1} − cum_s) ≤ 1,   P_t = exp(cum_{t-1})

    The pairwise decays stay in this log-space difference form: each is at
    most 1, where exp(cum_{t-1}) · exp(−cum_s) would overflow once a
    chunk's −cum reaches ~88.  The (B, L, L, H, K) pairwise tensor is
    materialised in f32.  T must be a multiple of min(chunk, T).
    """
    B, T, H, K = r.shape
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} must be a multiple of chunk={L}")
    rf, kf, vf = (a.float() for a in (r, k, v))
    lw = torch.log(w.float().clamp(1e-38, 1.0))
    uf, s = u.float(), state.float()
    tri = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)  # strict s < t
    eye = torch.eye(L, device=r.device)
    outs = []
    for c0 in range(0, T, L):
        rc, kc, vc, lwc = (a[:, c0:c0 + L] for a in (rf, kf, vf, lw))  # (B, L, H, ·)
        cum = lwc.cumsum(1)  # inclusive: cum_t = Σ_{i<=t} lw_i
        prev = cum - lwc  # cum_{t-1}
        dmat = prev[:, :, None] - cum[:, None, :]  # (B, L, L, H, K): t = dim 1, s = dim 2
        dmat = torch.where(tri[None, :, :, None, None], dmat, NEG_INF)
        att = torch.einsum("bthk,btshk,bshk->bths", rc, dmat.exp(), kc)
        diag = torch.einsum("bthk,hk,bthk->bth", rc, uf, kc)  # u-bonus at s == t
        att = att + diag[..., None] * eye[None, :, None, :]
        intra = torch.einsum("bths,bshv->bthv", att, vc)
        inter = torch.einsum("bthk,bhkv->bthv", rc * prev.exp(), s)
        # chunk-end state: exp(cum_{L-1}) ⊙ S₀ + Σ_s exp(cum_{L-1} − cum_s) k_s v_sᵀ
        dend = (cum[:, -1:] - cum).exp()
        s = cum[:, -1].exp()[..., None] * s + torch.einsum("bshk,bshv->bhkv", kc * dend, vc)
        outs.append(intra + inter)
    return torch.cat(outs, 1).to(r.dtype), s.to(state.dtype)


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------


def mamba_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serial per-step recurrence, the oracle:

      h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗ B_t;   y_t = C_t·h_t + D ⊙ x_t

    f32 math; returns (y (B, T, DI) in x's dtype, state in its dtype).
    """
    xf, dtf, bf, cf = (a.float() for a in (x, dt, Bm, C))
    af, df, h = A.float(), D.float(), state.float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * af[None])  # (B, DI, N)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + df[None] * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), h.to(state.dtype)


def mamba_scan_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    state: torch.Tensor,
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked form of the same recurrence (the JAX package's production
    path): chunks of L steps in sequence, and inside a chunk an inclusive
    scan of the pairs (a_t, b_t) = (exp(dt_t ⊙ A), (dt_t x_t) ⊗ B_t) under

      (a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, b_l a_r + b_r)

    with the carried state prepended as step 0 (a = 1).  torch has no
    associative scan, so this one is Hillis–Steele: log2(L + 1) rounds, each
    combining every pair with the one ``d`` steps before it.  The
    (B, L + 1, DI, N) f32 pairs are materialised per chunk.  T must be a
    multiple of min(chunk, T).
    """
    B, T, DI = x.shape
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} must be a multiple of chunk={L}")
    xf, dtf, bf, cf = (a.float() for a in (x, dt, Bm, C))
    af, df, h = A.float(), D.float(), state.float()
    ys = []
    for c0 in range(0, T, L):
        xc, dtc, bc, cc = (a[:, c0:c0 + L] for a in (xf, dtf, bf, cf))
        a = torch.exp(dtc[..., None] * af[None, None])  # (B, L, DI, N)
        b = (dtc * xc)[..., None] * bc[:, :, None, :]
        a = torch.cat([torch.ones_like(a[:, :1]), a], 1)
        b = torch.cat([h[:, None], b], 1)
        d = 1
        while d <= L:
            b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1)
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
            d *= 2
        hs = b[:, 1:]  # (B, L, DI, N): the state after each step
        ys.append(torch.einsum("bldn,bln->bld", hs, cc) + df * xc)
        h = hs[:, -1].clone()  # a view would keep the chunk's whole stack alive
    return torch.cat(ys, 1).to(x.dtype), h.to(state.dtype)
