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

With ``return_lse`` both also write each row's log-sum-exp (f32 (B, Hq,
Sq)), which the backward needs.  The backward, K1b
(:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``), replaces
``repro/kernels/flash_vjp.py``'s ``_bwd_rule``: two passes, no atomics (dq
and delta per q tile; dk and dv per KV head and key tile, summed over its
G query heads in the block), on the tensor cores in bf16 at D 16 to 64 and
on the f32 CUDA cores otherwise (:func:`bwd_instances`).  ``ops.attention``
is the ``torch.autograd.Function`` that runs the two.

A CPU tensor takes the plain versions, :func:`plain` (``ref.mha_ref``),
``ref.flash_attention_lse_ref`` and ``ref.flash_attention_bwd_ref``; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_lse_ref
from repro_torch.kernels.ref import mha_ref as plain

HEAD_DIMS = (8, 16, 32, 64, 128)  # the instances csrc/flash_attention.cu builds
MMA_HEAD_DIMS = (16, 32, 64, 128)  # bf16 head dims on the tensor cores (multiples of 16)
# bf16 head dims of K1b on the tensor cores: at 128 its fragments and
# accumulators would take more than a thread's 255 registers
BWD_MMA_HEAD_DIMS = (16, 32, 64)


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a launch runs: a function of dtype and head dim only."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "flash_fwd_mma"
    return "flash_fwd_simt"


def bwd_instances(dtype: torch.dtype, head_dim: int) -> tuple[str, str]:
    """The two kernels a K1b call runs: a function of dtype and head dim only."""
    if dtype == torch.bfloat16 and head_dim in BWD_MMA_HEAD_DIMS:
        return "flash_bwd_dq_mma", "flash_bwd_dkdv_mma"
    return "flash_bwd_dq", "flash_bwd_dkdv"


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
           **more: torch.Tensor) -> None:
    """Raise on what the kernels do not take: q (B, Sq, Hq, D), k / v (B, Sk,
    Hkv, D), and ``more`` of q's shape, all of one dtype, contiguous and
    16-byte aligned on q's device."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or any(
            t.shape != q.shape for t in more.values()):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} " + " ".join(
                             f"{n} {tuple(t.shape)}" for n, t in more.items()))
    if Hq % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"{what}: Hq={Hq} Hkv={Hkv} D={D} unsupported "
                         f"(need Hq % Hkv == 0, D in {HEAD_DIMS})")
    tensors = {"q": q, "k": k, "v": v, **more}
    if q.dtype not in _build.DTYPE_CODES or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(f"{what}: dtypes " + " ".join(str(t.dtype) for t in tensors.values()))
    for name, t in tensors.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:  # the tiles arrive by 16-byte copies
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")


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
    return_lse: bool = False,
):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype;
    with ``return_lse``, (out, lse f32 (B, Hq, Sq))."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, **kw) if return_lse else plain(q, k, v, **kw)
    refuse_grad("flash_attention", "ops.attention differentiates through K1b", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check("flash_attention", q, k, v, window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib, fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), _build.DTYPE_CODES[q.dtype],
             B, Sq, Sk, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
             float(softcap or 0.0), float(scale), int(q_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b: the gradients (dq, dk, dv), in q / k / v's dtype, of
    :func:`flash_attention` for output grad ``dout``, from its output ``out``
    and ``lse``.  One call launches two kernels and counts one launch."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    _check("flash_attention_bwd", q, k, v, window, out=out, dout=dout)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 ({B}, {Hq}, {Sq}), "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _bwd_entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             _build.DTYPE_CODES[q.dtype], B, Sq, Sk, Hq, Hkv, D, int(causal),
             -1 if window is None else int(window), float(softcap or 0.0), float(scale),
             int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
