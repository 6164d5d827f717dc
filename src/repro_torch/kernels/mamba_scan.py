"""Mamba-1 selective scan (kernel K5): CUDA C++ for Hopper, ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_scan`` / ``_mamba_kernel``):

    h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗ B_t;   y_t = C_t·h_t + D ⊙ x_t

with x, dt (B, T, DI), A (DI, N), Bm, C (B, T, N), D (DI,) and the state
(B, DI, N) in f32; y in x's dtype, the final state in f32, all arithmetic
in f32.

What bounds it on the card: at the served prefill (B 1, T 512, DI 16384,
N 16) it moves ~53.5 MB (~16 us at 3.35 TB/s) but computes 134 M
exponentials, ~32 us on the special-function units, so the exponentials
set the bound.  One block per (batch, 32-channel tile) walks the whole of T
in a loop with the state in registers (channels share nothing but B_t and
C_t); 4 lanes share a channel's 16 state values, so a batch-1 prefill still
runs 16 warps per SM, and each lane's 4 exponentials per step are
independent of the recurrence.  The inputs are read in their (B, T, DI) /
(B, T, N) layout, with no transposed copies.  x, dt, Bm and C are f32 or
bf16 (one type), A, D and the state f32; all must be contiguous.

A CPU tensor takes the plain version, :func:`plain`
(``ref.mamba_scan_chunked``, which is what ``chunk`` is for); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import mamba_scan_chunked as plain

STATE_SIZES = (4, 8, 16)  # the N instances the source compiles


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, DI) in x's dtype, final state (B, DI, N) f32)."""
    if x.device.type == "cpu":
        return plain(x, dt, A, Bm, C, D, state, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for device {x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} must be 3-d and A {tuple(A.shape)} 2-d")
    B, T, DI = x.shape
    N = A.shape[1]
    want = {"dt": (B, T, DI), "A": (DI, N), "Bm": (B, T, N), "C": (B, T, N), "D": (DI,),
            "state": (B, DI, N)}
    got = {"dt": dt, "A": A, "Bm": Bm, "C": C, "D": D, "state": state}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"mamba_scan: {name} {tuple(got[name].shape)}, expected {shape}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size N={N} not in {STATE_SIZES}")
    if x.dtype not in _build.DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, Bm, C)):
        raise ValueError(f"mamba_scan: dtypes x {x.dtype} dt {dt.dtype} Bm {Bm.dtype} "
                         f"C {C.dtype} (one of {list(_build.DTYPE_CODES)})")
    if any(t.dtype != torch.float32 for t in (A, D, state)):
        raise ValueError(f"mamba_scan: dtypes A {A.dtype} D {D.dtype} state {state.dtype} "
                         "(all f32)")
    for name, t in (("x", x), *got.items()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous on {x.device}")
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    lib, fn = _entry()
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
             D.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
             _build.DTYPE_CODES[x.dtype], B, T, DI, N,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y, s_out
