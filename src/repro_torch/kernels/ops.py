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

import sys
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
# ``_TUNED[op][tier]`` is a kwargs dict overriding that entry point's knobs
# on one tier, ``kernel`` or ``plain`` (the dispatch tiers).  The tuner
# (``tune/``) fills it from sweep winners or a fleet-pulled store, and it
# takes precedence over the values callers pass, as in the JAX package:
#
# * ``kernel``: ``decode_attention`` ``waves``, ``moe_gmm``
#   ``max_row_tiles``, ``rwkv6_scan`` ``column_tile``, passed to the
#   wrappers (the plans of ``kernels/plan.py``);
# * ``plain``: ``rwkv6_scan`` / ``mamba_scan`` ``chunk``, the chunked
#   forms' chunk, kept only where it divides T (:func:`_scan_chunk`).
#
# A call runs on the ``plain`` tier under ``impl="plain"`` or for a CPU
# tensor, else on ``kernel``.  Overrides apply when a call runs, so a CUDA
# graph bakes the ones of its capture: ``serving/compiled.py`` refuses to
# replay a step under other ones (``config_tag``).
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


def _scan_chunk(op: str, tier: str, chunk: int, T: int) -> int:
    """Tuned chunk for a scan op, kept only when it divides the seq length.

    The chunked scans require ``T % min(chunk, T) == 0``; a winner swept on
    one workload shape must not crash another, so an indivisible override
    falls back to the caller's value (``repro.kernels.ops._scan_chunk``).
    """
    tuned = _TUNED.get(op, {}).get(tier, {}).get("chunk")
    if tuned is not None and T % min(int(tuned), T) == 0:
        return int(tuned)
    return chunk


def _tier(impl: str, x: torch.Tensor) -> str:
    """The dispatch tier a resolved ``impl`` runs on for ``x``."""
    return "plain" if impl == "plain" or x.device.type != "cuda" else "kernel"


@contextmanager
def tuned_scope(
    table: Mapping[str, Mapping[str, Mapping[str, Any]]],
) -> Iterator[None]:
    """Temporarily install tuned overrides (sweep measurement, tests)."""
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


# ---------------------------------------------------------------------------
# DTensor operands (a step on a mesh, distributed/): each op below runs on
# every rank's local shards, as GSPMD runs the JAX package's: rows of the
# batch, and for attention its heads, stay where they are, and a dim the
# op needs whole (a norm's last dim, a cache's sequence without the split
# combine, a scan's time) is gathered first.  The kernel or its plain
# version then sees plain tensors; on a 1 x 1 mesh nothing moves.
# ---------------------------------------------------------------------------


def _dtensor(*ts: Any) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")  # none until something imported it
    return mod is not None and any(isinstance(t, mod.DTensor) for t in ts)


def _mesh_of(*ts: Any):
    from torch.distributed.tensor import DTensor

    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _common_plan(specs: list[tuple[torch.Tensor, dict[int, int]]]) -> list:
    """One placement per mesh dim: ``Shard(d)`` where every DTensor that
    has plan dim ``d`` shards the dim it maps it to there (``specs``:
    (tensor, {plan dim: its dim})), else ``Replicate()``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    specs = [(t, dims) for t, dims in specs if isinstance(t, DTensor)]
    mesh = specs[0][0].device_mesh
    plan = []
    for i in range(mesh.ndim):
        got = None
        for d in sorted({d for _, dims in specs for d in dims}):
            having = [(t, dims) for t, dims in specs if d in dims]
            if all(t.placements[i].is_shard() and t.placements[i].dim == dims[d]
                   for t, dims in having):
                got = Shard(d)
        plan.append(got or Replicate())
    return plan


def _as(t: torch.Tensor, plan: list, dims: dict[int, int], mesh: Any) -> torch.Tensor:
    """``t``'s local shard under ``plan`` (its plan dim d is ``t``'s dim
    ``dims[d]``; a dim of the plan ``t`` lacks is replicated, and its
    gradient from each rank's part of the op is a partial sum there).  A
    plain tensor is taken as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    want = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims else Replicate()
            for p in plan]
    if not isinstance(t, DTensor):
        if all(w.is_replicate() for w in want):
            return t
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    grads = [Partial() if p.is_shard() and w.is_replicate() else w for p, w in zip(plan, want)]
    return t.to_local(grad_placements=grads)


def on_shards(fn, specs: list, out_dims: dict[int, int]) -> Any:
    """``fn`` on each rank's local shards: ``specs`` is [(tensor or other
    arg, {plan dim: its dim})]; the plan keeps a plan dim sharded where every
    DTensor that has it shards it alike, and gathers the rest; the outputs
    (a tensor or a tuple of them) come back as DTensors whose dims
    ``out_dims`` map plan dims to."""
    mesh = _mesh_of(*(a for a, _ in specs))
    plan = _common_plan([(a, d) for a, d in specs if isinstance(a, torch.Tensor)])
    out = fn(*(_as(a, plan, d, mesh) if isinstance(a, torch.Tensor) else a for a, d in specs))
    if isinstance(out, tuple):
        return tuple(_wrap(o, mesh, plan, out_dims) for o in out)
    return _wrap(out, mesh, plan, out_dims)


def _wrap(out: Any, mesh, plan: list, dims: dict[int, int]) -> Any:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims else Replicate() for p in plan]
    return DTensor.from_local(out, mesh, pl, run_check=False)


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
    if _dtensor(q, k, v):  # batch and heads stay sharded
        bh = {0: 0, 2: 2}
        return on_shards(lambda *t: attention(*t, causal=causal, window=window, softcap=softcap,
                                              q_offset=q_offset, impl=impl),
                         [(q, bh), (k, bh), (v, bh)], bh)
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
    if _dtensor(q, k_cache, v_cache):  # batch and heads stay; the sequence is gathered
        qd, cd, rd = {0: 0, 2: 1}, {0: 0, 2: 2}, {0: 0}
        return on_shards(lambda *t: decode_attention(*t, window=window, softcap=softcap,
                                                     impl=impl),
                         [(q, qd), (k_cache, cd), (v_cache, cd), (pos_ids, rd), (cur_pos, rd)], qd)
    if _resolve(impl, q) == "plain":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos_ids, cur_pos,
                                         window=window, softcap=softcap)
    out = _decode_kernel(q, k_cache, v_cache, pos_ids, cur_pos, window=window,
                         softcap=softcap, **tuned_overrides("decode_attention", "kernel"))
    if _sdfg.ACTIVE is not None:  # every slot: which are live is on the card
        B, Hq, D = q.shape
        _note("decode_attention", (q, k_cache, v_cache, pos_ids, cur_pos), (out,),
              4 * D * B * Hq * k_cache.shape[1])
    return out


def decode_attention_seq_sharded(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_ids: torch.Tensor,
    cur_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    seq_axes: tuple[str, ...] = ("model",),
    batch_axes: tuple[str, ...] = (),
    impl: Optional[str] = None,
) -> Optional[torch.Tensor]:
    """Split-KV decode over a sequence-sharded cache (the flash-decoding
    combine across devices; ``repro/kernels/ops.py``'s shard_map).

    Each rank computes its cache shard's unnormalised partials (acc, m, l)
    through K2's stats mode (the plain ``ref.decode_attention_ref(
    return_stats=True)`` on the CPU), then the ranks all-reduce MAX of m
    over the ``seq_axes`` group(s), SUM acc e^(m - m_g) and l e^(m - m_g)
    over them, and divide by max(l_g, 1e-30): only (B, H, D)-sized
    partials cross devices, never the cache.  A row with no live slot in
    any shard gives exactly 0 from the kernel (the plain version: the mean
    of V, ROADMAP R9).

    The mesh is the ambient one (``distributed.constrain.mesh_scope``).
    DTensor operands are taken shard by shard (``to_local``; q and cur_pos
    replicated over the sequence axes, the batch as the cache's) and the
    result is a DTensor replicated there; plain tensors are this rank's
    shard as they are (a mesh of one device: the whole cache).
    ``batch_axes`` names the mesh axes the batch is sharded over, as in the
    JAX signature; the cache's placements say the same.  Returns None where
    there is no ambient mesh or one of ``seq_axes`` is not in it (the caller
    falls back to :func:`decode_attention`)."""
    from repro_torch.distributed.constrain import ambient_mesh, is_dtensor

    mesh = ambient_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or not seq_axes or any(a not in names for a in seq_axes):
        return None
    del batch_axes  # the cache's placements carry them
    import torch.distributed._functional_collectives as funcol

    sharded = is_dtensor(k_cache)
    placements = None
    if sharded:
        from torch.distributed.tensor import DTensor, Replicate

        mesh, placements = k_cache.device_mesh, k_cache.placements
        # q (B, Hq, D) and cur_pos (B,): the batch placements of the cache,
        # replicated over every other mesh dim
        row = [p if (p.is_shard() and p.dim == 0) else Replicate() for p in placements]
        q, cur_pos = (t.redistribute(mesh, row).to_local() if is_dtensor(t) else t
                      for t in (q, cur_pos))
        k_cache, v_cache, pos_ids = (t.to_local() for t in (k_cache, v_cache, pos_ids))
    if _resolve(impl, q) == "plain":
        acc, m, l = _ref.decode_attention_ref(q, k_cache, v_cache, pos_ids, cur_pos,
                                              window=window, softcap=softcap, return_stats=True)
    else:
        acc, m, l = _decode_kernel(q, k_cache, v_cache, pos_ids, cur_pos, window=window,
                                   softcap=softcap, return_stats=True,
                                   **tuned_overrides("decode_attention", "kernel"))
        if _sdfg.ACTIVE is not None:
            B, Hq, D = q.shape
            _note("decode_attention_stats", (q, k_cache, v_cache, pos_ids, cur_pos),
                  (acc, m, l), 4 * D * B * Hq * k_cache.shape[1])
    groups = [(mesh, names.index(a)) for a in seq_axes]

    def over(op: str):
        def reduce(t: torch.Tensor) -> torch.Tensor:
            for g in groups:
                t = funcol.all_reduce(t, op, g)
            return t
        return reduce

    out = combine_partials(acc, m, l, over("max"), over("sum"), q.dtype)
    if sharded:
        return DTensor.from_local(out, mesh, row, run_check=False)
    return out


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, all_max, all_sum,
                     dtype: torch.dtype) -> torch.Tensor:
    """The flash-decoding combine of partials (acc (..., B, Hkv, G, D), m
    and l (..., B, Hkv, G)) held across ranks or stacked on a leading axis:
    m_g = all_max(m), then out = all_sum(acc e^(m - m_g)) / max(all_sum(l
    e^(m - m_g)), 1e-30) -> (B, Hkv * G, D) in ``dtype``.  The mesh path's
    reductions are all-reduces over the sequence axes; a stack's, a max
    (keeping the axis) and a sum over it."""
    m_g = all_max(m)
    w = torch.exp(m - m_g)
    acc, l = all_sum(acc * w[..., None]), all_sum(l * w)
    B, Hkv, G, D = acc.shape
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Hkv * G, D).to(dtype)


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, impl: Optional[str] = None
) -> torch.Tensor:
    """(1 + scale) RMSNorm, f32 math, x's dtype out."""
    if _dtensor(x, scale):  # rows stay sharded; each row's D is gathered
        rows = {d: d for d in range(x.dim() - 1)}
        return on_shards(lambda a, b: rmsnorm(a, b, eps=eps, impl=impl), [(x, rows), (scale, {})],
                         rows)
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
    out = _gmm_kernel(x, w, epilogue=epilogue, **tuned_overrides("moe_gmm", "kernel"))
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
    if _dtensor(x, w1, w3, w2):
        # experts stay where the weights are expert-sharded (x's expert dim
        # is cut locally to match), the token rows where x's are; the
        # weights' other shards (FSDP over embed) are gathered
        from torch.distributed.tensor import Replicate, Shard

        mesh = _mesh_of(x, w1, w3, w2)
        plan = []
        for i in range(mesh.ndim):
            wp = w1.placements[i] if _dtensor(w1) else Replicate()
            xp = x.placements[i] if _dtensor(x) else Replicate()
            plan.append(Shard(0) if wp.is_shard() and wp.dim == 0 else
                        Shard(1) if xp.is_shard() and xp.dim == 1 else Replicate())
        xe, we = {0: 0, 1: 1}, {0: 0}
        out = moe_ffn(_as(x, plan, xe, mesh), *(_as(w, plan, we, mesh) for w in (w1, w3, w2)),
                      act=act, impl=impl)
        return _wrap(out, mesh, plan, xe)
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
    if _dtensor(r, k, v, w, state):  # batch rows stay sharded
        b = {0: 0}
        return on_shards(lambda *t: rwkv6_scan(*t, chunk=chunk, impl=impl),
                         [(r, b), (k, b), (v, b), (w, b), (u, {}), (state, b)], b)
    T = r.shape[1]
    impl = _resolve(impl, r)
    chunk = _scan_chunk("rwkv6_scan", _tier(impl, r), chunk, T)
    if T % min(chunk, T):
        raise ValueError(f"T={T} must be a multiple of chunk={min(chunk, T)}")
    if impl == "plain":
        return _ref.rwkv6_scan_chunked(r, k, v, w, u, state, chunk=chunk)
    out = _rwkv6_kernel(r, k, v, w, u, state, chunk=chunk,
                        **tuned_overrides("rwkv6_scan", "kernel"))
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
    Plain PyTorch, as the JAX package's step is plain jnp; DTensors run on
    their shards (batch and heads kept)."""
    if _dtensor(r, k, v, w, state):
        bh = {0: 0, 1: 1}
        return on_shards(rwkv6_step, [(r, bh), (k, bh), (v, bh), (w, bh), (u, {1: 0}),
                                      (state, bh)], bh)
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
    if _dtensor(x, dt, Bm, C, state):  # batch rows stay sharded
        b = {0: 0}
        return on_shards(lambda *t: mamba_scan(*t, chunk=chunk, impl=impl),
                         [(x, b), (dt, b), (A, {}), (Bm, b), (C, b), (D, {}), (state, b)], b)
    T = x.shape[1]
    impl = _resolve(impl, x)
    chunk = _scan_chunk("mamba_scan", _tier(impl, x), chunk, T)
    if T % min(chunk, T):
        raise ValueError(f"T={T} must be a multiple of chunk={min(chunk, T)}")
    if impl == "plain":
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
    Plain PyTorch, as the JAX package's step is plain jnp; DTensors run on
    their shards (batch and channels kept)."""
    if _dtensor(x, dt, Bm, C, state):
        bc, b, c = {0: 0, 1: 1}, {0: 0}, {1: 0}
        return on_shards(mamba_step, [(x, bc), (dt, bc), (A, c), (Bm, b), (C, b), (D, c),
                                      (state, bc)], bc)
    xf, dtf, bf, cf = (a.float() for a in (x, dt, Bm, C))
    af, df, hf = A.float(), D.float(), state.float()
    h = torch.exp(dtf[..., None] * af[None]) * hf + (dtf * xf)[..., None] * bf[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cf) + df[None] * xf
    return y.to(x.dtype), h.to(state.dtype)
