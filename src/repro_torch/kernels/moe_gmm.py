"""Grouped expert matmul (kernel K4): CUDA C++ for Hopper, ``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py`` (``gmm`` /
``_gmm_kernel``): ``(E, C, D) @ (E, D, F) -> (E, C, F)``, one matmul per
expert over its capacity bucket, f32 accumulation, and an optional fused
``silu`` / tanh-``gelu`` epilogue on the f32 accumulator before the one
rounding to x's dtype.

What bounds it on the card: streaming every expert's weights once (~369 MB
in bf16 at deepseek-moe-16b's shapes, ~0.11 ms at 3.35 TB/s); the products
take a fifth of that on the tensor cores.  One block per (expert, 64-row C
tile, 128-column F tile) walks D in a loop with the tiles double-buffered in
shared memory; a C tile as tall as the capacity reads each weight element
once.  bf16 products run on the tensor cores (WMMA), f32 products on the
CUDA cores in full f32.  The ragged C / F / D edges are masked in the kernel.

A CPU tensor takes the plain version, :func:`plain` (``ref.gmm_ref``); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import gmm_ref as plain

EPILOGUE_CODES = {None: 0, "silu": 1, "gelu": 2}  # enum Epilogue in the source


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gmm(x: torch.Tensor, w: torch.Tensor, *, epilogue: Optional[str] = None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, f32 accumulation."""
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"moe_gmm: epilogue {epilogue!r} not in {list(EPILOGUE_CODES)}")
    if x.device.type == "cpu":
        return plain(x, w, epilogue=epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for device {x.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"moe_gmm: dtypes {x.dtype} {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} must be contiguous on {x.device}")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
             EPILOGUE_CODES[epilogue], E, C, D, F,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "moe_gmm")
    LAUNCHES["moe_gmm"] += 1
    return out
