"""Param factory + basic modules (linear, RMSNorm, embedding, RoPE).

Counterpart of ``repro/nn/core.py``.  Parameters are nested dicts of tensors
with the JAX package's names, shapes and layouts, so a JAX param tree
converts leaf for leaf (``repro_torch.models.convert``).  A module is two
functions: ``foo_init(pf, ...)`` declares its parameters through a
:class:`ParamFactory` (shape, **logical axes**, init law), and
``foo(params, x, ...)`` applies them.  The builder is the one source of
truth: under a :class:`ParamFactory` it gives tensors (on the ``meta``
device, shapes only), under an :class:`AxesFactory` the logical-axes tree
that ``distributed/sharding.py`` maps onto a mesh.

The port draws its own initial values from a ``torch.Generator`` under the
same laws (normal std 0.02 unless scaled, embedding std ``dim**-0.5``, zero
biases and norm scales, the deterministic inits of the RWKV layers); it does
not reproduce ``jax.random``'s bits.
"""
from __future__ import annotations

import math
import sys
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

Axes = tuple[Optional[str], ...]


def axes_str(axes: Axes) -> str:
    """Logical axes as one comma-joined string ('' for a dim that no rule
    shards): a string is a leaf of the tree, where a tuple would not be."""
    return ",".join(a if a else "" for a in axes)


def parse_axes(s: str) -> Axes:
    if s == "":
        return ()
    return tuple(a if a else None for a in s.split(","))


class ParamFactory:
    """Realises initialised tensors from one ``torch.Generator``.

    Inside :meth:`stacked`, every parameter gains a leading axis of that
    length: the per-period stacking of ``repro.models.lm._stacked_init``.
    """

    def __init__(
        self, generator: torch.Generator, param_dtype: torch.dtype, device: torch.device
    ) -> None:
        self.generator = generator
        self.param_dtype = param_dtype
        self.device = device
        self._lead: tuple[int, ...] = ()

    @contextmanager
    def stacked(self, n: int) -> Iterator[None]:
        prev = self._lead
        self._lead = prev + (n,)
        try:
            yield
        finally:
            self._lead = prev

    def param(
        self,
        shape: Sequence[int],
        axes: Axes,
        init: str | Callable[[tuple[int, ...]], torch.Tensor] = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """One parameter of ``shape`` (plus the stacked leading axes), whose
        dims carry the logical ``axes``.

        ``init`` is ``"normal"`` (std ``scale``, default 0.02), ``"zeros"``,
        ``"ones"``, or a deterministic callable ``init(shape)`` that returns
        one period's f32 values; it is called once per period, as the JAX
        package's vmapped init calls it once per period key.
        """
        _check_axes(shape, axes)
        shape = self._lead + tuple(shape)
        dtype = dtype or self.param_dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init != "normal" and not callable(init):
            raise ValueError(f"unknown init {init!r}")
        # Drawn in f32 one leading slice at a time (one period of a stacked
        # leaf), so the f32 draw of a large stacked leaf (deepseek's experts:
        # 27 x 738 MB) never exists whole beside the weights.
        std = 0.02 if scale is None else scale
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for part in (out.unbind(0) if self._lead else (out,)):
            if callable(init):
                x = init(tuple(part.shape)).to(self.device)
            else:
                x = torch.randn(part.shape, generator=self.generator, dtype=torch.float32,
                                device=self.device).mul_(std)
            part.copy_(x)
        return out


def _check_axes(shape: Sequence[int], axes: Axes) -> None:
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims but axes {axes} "
                         f"has {len(axes)}")


class AxesFactory(ParamFactory):
    """Realises the logical-axes tree: each leaf the comma-joined axes of
    its parameter, ``layers`` first for a stacked one (the JAX package's
    ``repro.nn.core.AxesFactory``)."""

    def __init__(self) -> None:
        super().__init__(None, torch.float32, torch.device("meta"))

    def param(self, shape, axes, init="normal", scale=None, dtype=None) -> str:  # type: ignore[override]
        _check_axes(shape, axes)
        return axes_str(("layers",) * len(self._lead) + tuple(axes))


def linear_init(
    pf: ParamFactory,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    in_axes: Axes,
    out_axes: Axes,
    *,
    bias: bool = False,
    scale: Optional[float] = None,
) -> dict:
    """General (possibly multi-dim) linear: contracts all of ``in_shape``."""
    p = {"w": pf.param(tuple(in_shape) + tuple(out_shape), tuple(in_axes) + tuple(out_axes),
                       scale=scale)}
    if bias:
        p["b"] = pf.param(tuple(out_shape), tuple(out_axes), init="zeros")
    return p


def linear(p: dict, x: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of x with the first ``n_in`` of w.

    x and the params share one dtype, which the output keeps, as
    ``preferred_element_type=x.dtype`` gives in the JAX package.
    """
    w = p["w"]
    if _sharded(x) or _sharded(w):
        out = _linear_sharded(x, w, n_in)
    else:
        out = torch.tensordot(x, w, dims=n_in)
    if "b" in p:
        out = out + p["b"]
    return out


def _sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``DTensor`` (no import on the unsharded path)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _linear_sharded(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """:func:`linear` of DTensors, on each rank's shards, as GSPMD lays it
    out: on a mesh dim where x splits a leading (batch) dim the product
    stays split so and w is gathered there (the FSDP gather of its embed
    dim); where w splits an output dim (heads, ffn width, vocab) it stays
    split so and x is gathered there; where either splits only contracted
    dims, both are gathered.  The local product is :func:`linear`'s own
    ``tensordot``, so a 1 x 1 mesh computes bit for bit what no mesh does.
    A replicated operand of a split product gets a partial gradient from
    each rank's part."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (x if _sharded(x) else w).device_mesh
    lead = x.dim() - n_in
    x_pl, w_pl, out_pl = [], [], []
    for i in range(mesh.ndim):
        xp = x.placements[i] if _sharded(x) else Replicate()
        wp = w.placements[i] if _sharded(w) else Replicate()
        if xp.is_shard() and xp.dim < lead:
            x_pl.append(xp), w_pl.append(Replicate()), out_pl.append(xp)
        elif wp.is_shard() and wp.dim >= n_in:
            x_pl.append(Replicate()), w_pl.append(wp), out_pl.append(Shard(lead + wp.dim - n_in))
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), out_pl.append(Replicate())

    def local(t, pl):
        if not _sharded(t):
            return t
        grads = [Partial() if o.is_shard() and q.is_replicate() else q for o, q in zip(out_pl, pl)]
        t = t if list(t.placements) == pl else t.redistribute(mesh, pl)
        return t.to_local(grad_placements=grads)

    out = torch.tensordot(local(x, x_pl), local(w, w_pl), dims=n_in)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def rmsnorm_init(pf: ParamFactory, dim: int, axis: Optional[str] = "embed") -> dict:
    # Norm scales live in f32: tiny and precision-critical.
    return {"scale": pf.param((dim,), (axis,), init="zeros", dtype=torch.float32)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(1 + scale)-parameterised RMSNorm, f32 math, x's dtype out.

    The JAX model computes this in jnp; the port sends it to the RMSNorm
    kernel (``ops.rmsnorm``) on the card.
    """
    return ops.rmsnorm(x, p["scale"], eps=eps)


def embedding_init(pf: ParamFactory, vocab: int, dim: int, *, scale: Optional[float] = None) -> dict:
    # std 1/sqrt(dim): unit-norm rows, so tied-unembed logits start at O(1).
    scale = dim**-0.5 if scale is None else scale
    return {"table": pf.param((vocab, dim), ("vocab", "embed"), scale=scale)}


def embed(p: dict, ids: torch.Tensor, *, scale_by_dim: bool = False) -> torch.Tensor:
    out = F.embedding(ids, p["table"])
    if scale_by_dim:
        # the factor is rounded to the table's dtype first, as in JAX; a 0-dim
        # tensor filled on out's device, so no host-to-device copy is needed
        out = out * out.new_full((), math.sqrt(p["table"].shape[1]))
    return out


class _UnembedF32(torch.autograd.Function):
    """x (N, D) @ table (V, D)^T -> f32 logits from bf16 operands on the card.
    ``torch.mm(..., out_dtype=float32)`` has no derivative in PyTorch; its
    backward here rounds the f32 logit gradient to the operands' bf16, as a
    TPU's default-precision f32 product does, and multiplies in bf16 with
    f32 accumulation."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return torch.mm(x, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = g.to(table.dtype)
        dx = torch.mm(g, table) if ctx.needs_input_grad[0] else None
        dtable = torch.mm(g.t(), x) if ctx.needs_input_grad[1] else None
        return dx, dtable


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to f32 vocab logits (tied-embedding transpose).

    The JAX package multiplies bf16 operands into an f32 output.  On the
    card, ``torch.mm(..., out_dtype=float32)`` does the same (cuBLAS, f32
    accumulation and output), reading the bf16 table as it is
    (:class:`_UnembedF32`, which also gives it a backward).  Elsewhere (the
    CPU has no such product) both operands are cast to f32, exactly, and
    multiplied in f32; a plain bf16 matmul would round its output to bf16.
    """
    table = p["table"]
    if _sharded(x) or _sharded(table):
        return _unembed_sharded(p, x)
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        out = _UnembedF32.apply(x.reshape(-1, x.shape[-1]), table)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return torch.matmul(x.float(), table.float().t())


def _unembed_sharded(p: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`unembed` of DTensors, on each rank's shards: x keeps its row
    shards and gathers its model dim, the table keeps its vocab shards and
    gathers its embed dim (the FSDP gather), and the logits come out
    sharded as both were, rows and vocab."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    table = p["table"]
    mesh = (x if _sharded(x) else table).device_mesh
    x_pl, t_pl, out_pl = [], [], []
    for i in range(mesh.ndim):
        xp = x.placements[i] if _sharded(x) else Replicate()
        tp_ = table.placements[i] if _sharded(table) else Replicate()
        if xp.is_shard() and xp.dim < x.dim() - 1:
            x_pl.append(xp), t_pl.append(Replicate()), out_pl.append(xp)
        elif tp_.is_shard() and tp_.dim == 0:
            x_pl.append(Replicate()), t_pl.append(tp_), out_pl.append(Shard(x.dim() - 1))
        else:
            x_pl.append(Replicate()), t_pl.append(Replicate()), out_pl.append(Replicate())

    def local(t, pl):
        # a replicated operand of a product split over a mesh dim gets a
        # partial gradient from each rank's part
        if not _sharded(t):
            return t
        grads = [Partial() if o.is_shard() and q.is_replicate() else q
                 for o, q in zip(out_pl, pl)]
        t = t if list(t.placements) == pl else t.redistribute(mesh, pl)
        return t.to_local(grad_placements=grads)

    out = unembed({"table": local(table, t_pl)}, local(x, x_pl))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies, f32: (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation.  x: (..., seq, heads, head_dim); positions:
    broadcastable to (..., seq).  Angles and rotation in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# silu and (tanh) gelu are the grouped-matmul kernel's epilogues too
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    **ref.EPILOGUES,
    "relu": F.relu,
}


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
