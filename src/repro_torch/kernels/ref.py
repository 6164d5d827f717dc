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


def _attn_mask(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int,
               k0: int, device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys k0 .. k0 + Sk - 1 query rows at positions
    q_offset .. q_offset + Sq - 1 see."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(k0, k0 + Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def flash_attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention with its row log-sum-exp, what K1 writes for a backward:
    (out (B, Sq, Hq, D) in q's dtype, lse f32 (B, Hq, Sq)), with
    lse = m + log(max(l, 1e-30)) over the scaled, softcapped, masked scores,
    the ``lse`` of ``repro/kernels/flash_vjp.py::_fwd_impl`` (query head h
    = hk * G + g of its (B, Hkv, G, Sq))."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, D).float() * scale, k.float())
    s = _softcap(s, softcap)
    s = torch.where(_attn_mask(Sq, Sk, causal, window, q_offset, 0, q.device), s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp(min=1e-30)  # (B, Hkv, G, Sq)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype), (m + torch.log(l)).reshape(B, Hq, Sq)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_k: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward, a blockwise mirror of
    ``repro/kernels/flash_vjp.py::_bwd_rule``: blocks of ``block_k`` keys,
    each recomputing its scores from q and k and P = exp(s - lse), with
    delta = sum dout * out, the softcap's chain rule 1 - (s / cap)^2 and the
    masks; f32 math, (dq, dk, dv) in q / k / v's dtypes.  A masked pair has
    P = 0 (``_bwd_rule`` zeroes its dS), so a row that sees no key gives
    zero gradients."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.reshape(B, Sq, Hkv, G, D).float()
    do = dout.reshape(B, Sq, Hkv, G, D).float()
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do, out.reshape(B, Sq, Hkv, G, D).float())
    lse = lse.float().reshape(B, Hkv, G, Sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, Sk, block_k):
        kf, vf = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
        chain = None
        if softcap:
            t = torch.tanh(s / softcap)
            s, chain = t * softcap, 1.0 - t * t
        ok = _attn_mask(Sq, kf.shape[1], causal, window, q_offset, k0, q.device)
        p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
        dv[:, k0:k0 + block_k] = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
        ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf) - delta[..., None])
        if chain is not None:
            ds = ds * chain
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
        dk[:, k0:k0 + block_k] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`rmsnorm_ref` for output grad dy, f32 math:
    with r = rsqrt(mean(x^2) + eps) and g = dy (1 + scale),
    dx = r g - x r^3 mean(g x) (in x's dtype) and dscale = sum over rows of
    dy x r (f32), as ``jax.grad`` of ``repro/nn/core.py::rmsnorm`` gives."""
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = gf * (1.0 + scale.float())
    dx = r * g - xf * r.pow(3) * (g * xf).mean(dim=-1, keepdim=True)
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


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


def act_and_grad(a: torch.Tensor, act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """act(a) and act'(a) in f32 for the gated FFN's activations, written
    out as K4b's epilogue computes them: silu' = s (1 + a (1 - s)) with
    s = sigmoid(a); the tanh gelu's 0.5 (1 + t) + 0.5 a (1 - t^2) k (1 +
    3 c a^2) with t = tanh(k (a + c a^3)), k = sqrt(2 / pi), c = 0.044715."""
    a = a.float()
    if act == "silu":
        s = torch.sigmoid(a)
        return a * s, s * (1.0 + a * (1.0 - s))
    if act == "gelu":
        k, c = math.sqrt(2.0 / math.pi), 0.044715
        t = torch.tanh(k * (a + c * a * a * a))
        return 0.5 * a * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * k * (
            1.0 + 3.0 * c * a * a)
    raise ValueError(f"act {act!r} not in {list(EPILOGUES)}")


def gmm_dgrad_ref(g: torch.Tensor, w: torch.Tensor, g2: Optional[torch.Tensor] = None,
                  w2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gradient of :func:`gmm_ref`'s x: g (E, C, F) @ w (E, D, F)^T ->
    (E, C, D), plus g2 @ w2^T when given, both products summed in one f32
    accumulator and rounded once to g's dtype (K4b's dgrad)."""
    acc = torch.bmm(g.float(), w.float().transpose(1, 2))
    if g2 is not None:
        acc = acc + torch.bmm(g2.float(), w2.float().transpose(1, 2))
    return acc.to(g.dtype)


def gmm_wgrad_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`gmm_ref`'s w: x (E, C, D)^T @ g (E, C, F) ->
    (E, D, F), summed over the capacity rows in f32, rounded once to x's
    dtype (K4b's wgrad)."""
    return torch.bmm(x.float().transpose(1, 2), g.float()).to(x.dtype)


def gmm_gated_dgrad_ref(dy: torch.Tensor, w2: torch.Tensor, a1: torch.Tensor, a3: torch.Tensor,
                        act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """K4b's dgrad with the gated epilogue: dh = dy (E, C, D) @ w2 (E, F,
    D)^T in f32 (never rounded), then from the pre-activation a1 = x @ w1
    (rounded to x's dtype) and the gate input a3 (E, C, F): da1 = dh a3
    act'(a1) and da3 = dh act(a1), in f32, each rounded once to dy's
    dtype."""
    dh = torch.bmm(dy.float(), w2.float().transpose(1, 2))
    g, dg = act_and_grad(a1, act)
    return (dh * a3.float() * dg).to(dy.dtype), (dh * g).to(dy.dtype)


def moe_ffn_fwd(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                act: str = "silu", gmm=gmm_ref):
    """The kernel route's gated FFN, as serving runs it: h = act(x @ w1) *
    (x @ w3), the activation on the f32 accumulator (fused into the first
    grouped matmul), the gate product of the two x-dtype results, y = h @
    w2.  ``gmm`` is K4's wrapper or :func:`gmm_ref`.  Returns (y, a3, h):
    with x and the weights, what the backward reads; it recomputes the
    pre-activation a1 = gmm(x, w1) (the same accumulator, rounded)."""
    g = gmm(x, w1, epilogue=act)
    a3 = gmm(x, w3)
    h = g * a3
    return gmm(h, w2), a3, h


def moe_ffn_bwd_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                    a1: torch.Tensor, a3: torch.Tensor, h: torch.Tensor, dy: torch.Tensor,
                    act: str = "silu"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit backward of :func:`moe_ffn_fwd` for output grad dy, given
    its a3 and h and the pre-activation a1 = gmm_ref(x, w1), with K4b's
    rounding points: (da1, da3) by :func:`gmm_gated_dgrad_ref`, dx =
    da1 @ w1^T + da3 @ w3^T rounded once, dw1 = x^T da1, dw3 = x^T da3 and
    dw2 = h^T dy.  Returns (dx, dw1, dw3, dw2)."""
    da1, da3 = gmm_gated_dgrad_ref(dy, w2, a1, a3, act)
    return (gmm_dgrad_ref(da1, w1, da3, w3), gmm_wgrad_ref(x, da1), gmm_wgrad_ref(x, da3),
            gmm_wgrad_ref(h, dy))


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
