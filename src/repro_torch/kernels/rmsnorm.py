"""RMSNorm (kernel K3): Triton for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``): (1 + scale) RMSNorm over rows, f32 math, the whole
model dim in one tile.

What bounds it on the card: it reads x once and writes y once, with no
matrix work, so bytes bound it; at serving sizes (8 or 512 rows of 896) it
moves kilobytes to a few megabytes and the launch itself dominates.  One
program per row loads the row into one masked power-of-two block (896 ->
1024), reduces the mean square with ``tl.sum`` in f32 and scales.  Triton
serves as well as CUDA C++ here: a row reduction plus an elementwise scale
is what its block model states directly.

``triton`` is imported inside the launching function only, so the package
imports where Triton is absent.  A CPU tensor takes the plain version,
:func:`plain` (``ref.rmsnorm_ref``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ref import rmsnorm_ref as plain

DTYPES = (torch.float32, torch.bfloat16)

tl = None  # triton.language, bound by _kernel() on first launch


def _rmsnorm_kernel(x_ptr, s_ptr, o_ptr, D, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    s = tl.load(s_ptr + cols, mask=mask, other=0.0)
    y = x / tl.sqrt(var + eps) * (1.0 + s)
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_rmsnorm_kernel), triton.next_power_of_2


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) f32.  (1 + scale) RMSNorm, f32 math, x's dtype out."""
    if x.device.type == "cpu":
        return plain(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm: scale must be f32 ({D},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: dtype {x.dtype}")
    if scale.device != x.device or not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: x and scale must be contiguous on {x.device}")
    kernel, next_pow2 = _kernel()
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        kernel[(rows,)](x, scale, out, D, float(eps), BLOCK=next_pow2(D), num_warps=4)
        LAUNCHES["rmsnorm"] += 1
    return out
