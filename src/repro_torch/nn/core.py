"""Param factory + basic modules (linear, RMSNorm, embedding, RoPE).

Counterpart of ``repro/nn/core.py``.  Parameters are nested dicts of tensors
with the JAX package's names, shapes and layouts, so a JAX param tree
converts leaf for leaf (``repro_torch.models.convert``).  A module is two
functions: ``foo_init(pf, ...)`` declares its parameters through a
:class:`ParamFactory`, and ``foo(params, x, ...)`` applies them.

The port draws its own initial values from a ``torch.Generator`` under the
same laws (normal std 0.02 unless scaled, embedding std ``dim**-0.5``, zero
biases and norm scales, the deterministic inits of the RWKV layers); it does
not reproduce ``jax.random``'s bits.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref


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
        init: str | Callable[[tuple[int, ...]], torch.Tensor] = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """One parameter of ``shape`` (plus the stacked leading axes).

        ``init`` is ``"normal"`` (std ``scale``, default 0.02), ``"zeros"``,
        ``"ones"``, or a deterministic callable ``init(shape)`` that returns
        one period's f32 values; it is called once per period, as the JAX
        package's vmapped init calls it once per period key.
        """
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


def linear_init(
    pf: ParamFactory,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    *,
    bias: bool = False,
    scale: Optional[float] = None,
) -> dict:
    """General (possibly multi-dim) linear: contracts all of ``in_shape``."""
    p = {"w": pf.param(tuple(in_shape) + tuple(out_shape), scale=scale)}
    if bias:
        p["b"] = pf.param(tuple(out_shape), init="zeros")
    return p


def linear(p: dict, x: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of x with the first ``n_in`` of w.

    x and the params share one dtype, which the output keeps, as
    ``preferred_element_type=x.dtype`` gives in the JAX package.
    """
    out = torch.tensordot(x, p["w"], dims=n_in)
    if "b" in p:
        out = out + p["b"]
    return out


def rmsnorm_init(pf: ParamFactory, dim: int) -> dict:
    # Norm scales live in f32: tiny and precision-critical.
    return {"scale": pf.param((dim,), init="zeros", dtype=torch.float32)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(1 + scale)-parameterised RMSNorm, f32 math, x's dtype out.

    The JAX model computes this in jnp; the port sends it to the RMSNorm
    kernel (``ops.rmsnorm``) on the card.
    """
    return ops.rmsnorm(x, p["scale"], eps=eps)


def embedding_init(pf: ParamFactory, vocab: int, dim: int, *, scale: Optional[float] = None) -> dict:
    # std 1/sqrt(dim): unit-norm rows, so tied-unembed logits start at O(1).
    scale = dim**-0.5 if scale is None else scale
    return {"table": pf.param((vocab, dim), scale=scale)}


def embed(p: dict, ids: torch.Tensor, *, scale_by_dim: bool = False) -> torch.Tensor:
    out = F.embedding(ids, p["table"])
    if scale_by_dim:
        # the factor is rounded to the table's dtype first, as in JAX; a 0-dim
        # tensor filled on out's device, so no host-to-device copy is needed
        out = out * out.new_full((), math.sqrt(p["table"].shape[1]))
    return out


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to f32 vocab logits (tied-embedding transpose).

    The JAX package multiplies bf16 operands into an f32 output.  On the
    card, ``torch.mm(..., out_dtype=float32)`` does the same (cuBLAS, f32
    accumulation and output), reading the bf16 table as it is.  Elsewhere
    (the CPU has no such product) both operands are cast to f32, exactly,
    and multiplied in f32; a plain bf16 matmul would round its output to
    bf16.
    """
    table = p["table"]
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), table.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return torch.matmul(x.float(), table.float().t())


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
