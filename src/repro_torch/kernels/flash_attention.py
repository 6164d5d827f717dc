"""Flash attention (kernel K1): CUDA C++ for Hopper, ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_fa_kernel``): online-softmax attention with f32
m / l / acc, causal, sliding ``window``, ``q_offset`` and tanh ``softcap``,
GQA (query head h reads KV head h // G).

What bounds it on the card: at the serving shapes the bytes (q, k, v in and
out once) set the card's bound, and only the tensor cores come near it.  The
instance depends on dtype and head dim alone (:func:`instance`):

* bf16 at D 16 / 32 / 64 / 128 runs ``flash_fwd_mma``, FlashAttention-2 on
  the tensor cores (``mma.sync`` m16n8k16, 64 q rows a block, bf16 K / V
  tiles of 64 keys in a 2-stage ``cp.async`` ring, the online softmax in
  registers, P rounded to bf16 for P·V);
* f32, and bf16 at D 8, run ``flash_fwd_simt``, the products on the f32
  CUDA cores, exact to f32 rounding (the f32 end-to-end gates run it).

Both compute each q tile's KV range from causal / window / q_offset and mask
the ragged Sq / Sk edges themselves instead of padding copies.

A CPU tensor takes the plain version, :func:`plain` (``ref.mha_ref``); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import mha_ref as plain

HEAD_DIMS = (8, 16, 32, 64, 128)  # the instances csrc/flash_attention.cu builds
MMA_HEAD_DIMS = (16, 32, 64, 128)  # bf16 head dims on the tensor cores (multiples of 16)


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a launch runs: a function of dtype and head dim only."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "flash_fwd_mma"
    return "flash_fwd_simt"


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(
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
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if Hq % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: Hq={Hq} Hkv={Hkv} D={D} unsupported "
                         f"(need Hq % Hkv == 0, D in {HEAD_DIMS})")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype} {k.dtype} {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:  # the tiles arrive by 16-byte copies
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lib, fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[q.dtype],
             B, Sq, Sk, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
             float(softcap or 0.0), float(scale), int(q_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
