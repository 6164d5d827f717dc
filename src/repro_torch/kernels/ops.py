"""Dispatch layer: one public op per hot spot, implementation chosen by ``impl``.

Counterpart of ``repro/kernels/ops.py``.  ``impl`` is one of:

* ``auto``   — the kernel wrapper, which launches the Hopper kernel for a
  CUDA tensor and runs the plain version for a CPU tensor;
* ``kernel`` — the Hopper kernel; raises for a tensor that is not on CUDA;
* ``plain``  — the plain PyTorch version (``kernels/ref.py``) on any
  device.  On the card only a caller that asks for it gets it:
  ``chip_smoke.py`` compares the kernels against it.

``impl=None`` takes the process default (``set_default_impl`` /
``impl_scope``, initially ``auto``).

Autograd: where a gradient is needed (grad mode on and an input that
requires grad), ``attention`` and ``rmsnorm`` under ``auto`` / ``kernel``
run as ``torch.autograd.Function``s, :class:`Attention` (K1 writing its
log-sum-exp, then K1b) and :class:`RMSNorm` (K3, then K3b), on the CPU
through the same classes with the plain versions inside.  ``plain`` stays
torch autograd through ``kernels/ref.py``, an independent yardstick.  The
other kernels have no backward kernel yet: on the card their wrappers
refuse such inputs (ROADMAP R11), and only ``plain`` differentiates them.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, Mapping, Optional

import torch

from repro_torch.core import sdfg as _sdfg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _fa_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd as _fa_bwd_kernel
from repro_torch.kernels.mamba_scan import mamba_scan as _mamba_kernel
from repro_torch.kernels.moe_gmm import gmm as _gmm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6_kernel

IMPLS = ("auto", "kernel", "plain")
_IMPL = "auto"


def set_default_impl(impl: str) -> None:
    global _IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    _IMPL = impl


@contextmanager
def impl_scope(impl: str) -> Iterator[None]:
    """Run a block with another default ``impl`` (the chip check's plain runs)."""
    prev = _IMPL
    set_default_impl(impl)
    try:
        yield
    finally:
        set_default_impl(prev)


def _resolve(impl: Optional[str], x: torch.Tensor) -> str:
    impl = impl or _IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on {x.device}")
    return impl


# ---------------------------------------------------------------------------
# Tuned kernel configs, copied from repro.kernels.ops with the same op names
# (flash_attention, decode_attention, moe_gmm, rwkv6_scan, mamba_scan) so
# that profile and tune keys line up across the two packages.
#
# ``_TUNED[op][impl]`` is a kwargs dict overriding that entry point's
# block/tile knobs.  The port's kernels take no knobs yet: their Hopper
# design space arrives with ROADMAP item M12, which fills this table.
# ---------------------------------------------------------------------------

_TUNED: dict[str, dict[str, dict[str, Any]]] = {}


def encode_config(params: Mapping[str, Any]) -> str:
    """Canonical ``"k=v,k2=v2"`` form of a config point (sorted by key)."""
    return ",".join(f"{k}={params[k]}" for k in sorted(params))


def set_tuned_configs(table: Mapping[str, Mapping[str, Mapping[str, Any]]]) -> None:
    """Install tuned config overrides: ``{op: {impl: {param: value}}}``."""
    global _TUNED
    _TUNED = {
        op: {impl: dict(params) for impl, params in impls.items()}
        for op, impls in table.items()
    }


def clear_tuned_configs() -> None:
    global _TUNED
    _TUNED = {}


def tuned_overrides(op: str, impl: str) -> dict[str, Any]:
    return dict(_TUNED.get(op, {}).get(impl, {}))


def active_config(op: str, impl: str) -> str:
    """Canonical ``"k=v,..."`` encoding of the active overrides ("" = default)."""
    return encode_config(_TUNED.get(op, {}).get(impl, {}))


def config_tag(impl: str) -> str:
    """Cross-op summary of active overrides for one backend tier."""
    parts = [
        f"{op}:{encode_config(impls[impl])}"
        for op, impls in sorted(_TUNED.items())
        if impls.get(impl)
    ]
    return ";".join(parts)


@contextmanager
def tuned_scope(
    table: Mapping[str, Mapping[str, Mapping[str, Any]]],
) -> Iterator[None]:
    """Temporarily install tuned overrides."""
    global _TUNED
    prev = _TUNED
    set_tuned_configs(table)
    try:
        yield
    finally:
        _TUNED = prev


# ---------------------------------------------------------------------------
# The SDFG record (core/sdfg.py): a kernel launches through ctypes, outside
# the dispatcher, so each entry below notes its launches to the running
# ``sdfg.extract``, behind one check of ``_sdfg.ACTIVE``.  The counts are
# those of the bounds in PERF.md §6: each input read once, each output
# written once.  A CPU tensor takes the plain version, whose aten ops the
# record sees one by one, so only launches on the card are noted.
# ---------------------------------------------------------------------------


def _note(name: str, ins, outs, flops: float, product: bool = True) -> None:
    if outs[0].is_cuda:
        _sdfg.ACTIVE.kernel(name, ins, outs, flops, product=product)


def _pairs(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int) -> int:
    """(query, key) pairs attention visits for one (batch, head)."""
    total = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(pos, Sk - 1) if causal else Sk - 1
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def _attention_flops(q, k, kw, per_pair: int) -> float:
    B, Sq, Hq, D = q.shape
    return per_pair * D * B * Hq * _pairs(Sq, k.shape[1], kw["causal"], kw["window"],
                                          kw["q_offset"])


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class Attention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward saves (q, k, v,
    out, lse); the backward recomputes P from them (K1 and K1b on the card,
    ``ref.flash_attention_lse_ref`` and ``ref.flash_attention_bwd_ref`` on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        out, lse = _fa_kernel(q, k, v, return_lse=True, **kw)
        if _sdfg.ACTIVE is not None:
            _note("flash_attention", (q, k, v), (out, lse), _attention_flops(q, k, kw, 4))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dk, dv = _fa_bwd_kernel(q, k, v, out, lse, dout, **ctx.kw)
        if _sdfg.ACTIVE is not None:
            _note("flash_attention_bwd", (q, k, v, out, lse, dout), (dq, dk, dv),
                  _attention_flops(q, k, ctx.kw, 10))
        return dq, dk, dv, None, None, None, None


class RMSNorm(torch.autograd.Function):
    """(1 + scale) RMSNorm with its backward (K3 and K3b on the card,
    ``ref.rmsnorm_ref`` and ``ref.rmsnorm_bwd_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        out = _rmsnorm_kernel(x, scale, eps=eps)
        if _sdfg.ACTIVE is not None:
            _note("rmsnorm", (x, scale), (out,), 4 * x.numel(), product=False)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        dx, dscale = _rmsnorm_bwd_kernel(x, scale, dy, eps=ctx.eps)
        if _sdfg.ACTIVE is not None:
            _note("rmsnorm_bwd", (x, scale, dy), (dx, dscale), 8 * x.numel(), product=False)
        return dx, dscale, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Training/prefill attention: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D)."""
    if _resolve(impl, q) == "plain":
        return _ref.mha_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                            q_offset=q_offset)
    if _wants_grad(q, k, v):
        return Attention.apply(q, k, v, causal, window, softcap, q_offset)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out = _fa_kernel(q, k, v, **kw)
    if _sdfg.ACTIVE is not None:
        _note("flash_attention", (q, k, v), (out,), _attention_flops(q, k, kw, 4))
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_ids: torch.Tensor,
    cur_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One token per sequence against a position-tagged KV cache."""
    if _resolve(impl, q) == "plain":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos_ids, cur_pos,
                                         window=window, softcap=softcap)
    out = _decode_kernel(q, k_cache, v_cache, pos_ids, cur_pos, window=window,
                         softcap=softcap)
    if _sdfg.ACTIVE is not None:  # every slot: which are live is on the card
        B, Hq, D = q.shape
        _note("decode_attention", (q, k_cache, v_cache, pos_ids, cur_pos), (out,),
              4 * D * B * Hq * k_cache.shape[1])
    return out


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, impl: Optional[str] = None
) -> torch.Tensor:
    """(1 + scale) RMSNorm, f32 math, x's dtype out."""
    if _resolve(impl, x) == "plain":
        return _ref.rmsnorm_ref(x, scale, eps=eps)
    if _wants_grad(x, scale):
        return RMSNorm.apply(x, scale, eps)
    out = _rmsnorm_kernel(x, scale, eps=eps)
    if _sdfg.ACTIVE is not None:
        _note("rmsnorm", (x, scale), (out,), 4 * x.numel(), product=False)
    return out


def gmm(x: torch.Tensor, w: torch.Tensor, *, epilogue: Optional[str] = None,
        impl: Optional[str] = None) -> torch.Tensor:
    """Grouped expert matmul (E, C, D) @ (E, D, F) -> (E, C, F), f32 accumulation."""
    if _resolve(impl, x) == "plain":
        return _ref.gmm_ref(x, w, epilogue=epilogue)
    return _gmm(x, w, epilogue)


def _gmm(x: torch.Tensor, w: torch.Tensor, epilogue: Optional[str] = None) -> torch.Tensor:
    out = _gmm_kernel(x, w, epilogue=epilogue)
    if _sdfg.ACTIVE is not None:
        E, C, D = x.shape
        _note("moe_gmm", (x, w), (out,), 2 * E * C * D * w.shape[-1])
    return out


def moe_ffn(
    x: torch.Tensor,
    w1: torch.Tensor,
    w3: torch.Tensor,
    w2: torch.Tensor,
    *,
    act: str = "silu",
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Per-expert gated FFN over capacity buckets: act(x@w1) * (x@w3) @ w2.

    The kernel route is the JAX package's Pallas composition: three grouped
    matmuls, the activation fused into the first, and the gate product of
    two x-dtype tensors in between.  The plain route (``ref.moe_ffn_ref``)
    applies the activation to the rounded product in f32, so in bf16 the
    two round at different places, as the JAX package's two routes do.
    """
    if _resolve(impl, x) == "plain":
        return _ref.moe_ffn_ref(x, w1, w3, w2, act=act)
    h = _gmm(x, w1, act) * _gmm(x, w3)
    return _gmm(h, w2)


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
    *,
    chunk: int = 32,
    remat_chunks: bool = False,
    impl: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV scan: r, k, w (B, T, H, K); v (B, T, H, V); u (H, K);
    state (B, H, K, V) -> (out (B, T, H, V) in r's dtype, final state).

    T must be a multiple of min(chunk, T) on every route, as in the JAX
    package, though the kernel itself walks any T.  ``remat_chunks`` only
    matters for a backward pass; it is accepted and ignored.
    """
    T = r.shape[1]
    if T % min(chunk, T):
        raise ValueError(f"T={T} must be a multiple of chunk={min(chunk, T)}")
    if _resolve(impl, r) == "plain":
        return _ref.rwkv6_scan_chunked(r, k, v, w, u, state, chunk=chunk)
    out = _rwkv6_kernel(r, k, v, w, u, state, chunk=chunk)
    if _sdfg.ACTIVE is not None:  # a step: kv outer product, state update, r . state
        B, T, H, K = r.shape
        _note("rwkv6_scan", (r, k, v, w, u, state), out, 4 * B * T * H * K * v.shape[-1],
              product=False)
    return out


def rwkv6_step(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the recurrence: r, k, w (B, H, K); v (B, H, V);
    state (B, H, K, V) -> (out (B, H, V) in r's dtype, state in its dtype).
    Plain PyTorch, as the JAX package's step is plain jnp."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    sf = state.float()
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf, sf + u.float()[None, :, :, None] * kv)
    return out.to(r.dtype), (wf[..., None] * sf + kv).to(state.dtype)


def mamba_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    state: torch.Tensor,
    *,
    chunk: int = 128,
    remat_chunks: bool = False,
    impl: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan: x, dt (B, T, DI); A (DI, N); Bm, C (B, T, N);
    D (DI,); state (B, DI, N) -> (y (B, T, DI) in x's dtype, final state).

    T must be a multiple of min(chunk, T) on every route, as in the JAX
    package, though the kernel itself walks any T.  ``remat_chunks`` only
    matters for a backward pass; it is accepted and ignored.
    """
    T = x.shape[1]
    if T % min(chunk, T):
        raise ValueError(f"T={T} must be a multiple of chunk={min(chunk, T)}")
    if _resolve(impl, x) == "plain":
        return _ref.mamba_scan_chunked(x, dt, A, Bm, C, D, state, chunk=chunk)
    out = _mamba_kernel(x, dt, A, Bm, C, D, state, chunk=chunk)
    if _sdfg.ACTIVE is not None:  # a step: decay, input, state update, C . state
        B, T, DI = x.shape
        _note("mamba_scan", (x, dt, A, Bm, C, D, state), out, 6 * B * T * DI * A.shape[1],
              product=False)
    return out


def mamba_step(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, C: torch.Tensor,
    D: torch.Tensor, state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the recurrence: x, dt (B, DI); Bm, C (B, N);
    state (B, DI, N) -> (y (B, DI) in x's dtype, state in its dtype).
    Plain PyTorch, as the JAX package's step is plain jnp."""
    xf, dtf, bf, cf = (a.float() for a in (x, dt, Bm, C))
    af, df, hf = A.float(), D.float(), state.float()
    h = torch.exp(dtf[..., None] * af[None]) * hf + (dtf * xf)[..., None] * bf[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cf) + df[None] * xf
    return y.to(x.dtype), h.to(state.dtype)
