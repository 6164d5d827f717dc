"""RWKV6 WKV scan (kernel K6): CUDA C++ for Hopper, ``csrc/rwkv6_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``rwkv6_scan`` / ``_rwkv6_kernel``):

    out_t = r_t · (S_t + diag(u) k_t v_tᵀ);   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

with r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) and the state
(B, H, K, V) in f32; out in r's dtype, all arithmetic in f32.

What bounds it on the card: at the served prefill (B 1, T 512, 64 heads of
64) it moves ~27 MB and does ~0.54 GFLOP of f32 work, ~8 us either way.
One block per (batch, head, 16-column V tile) walks time in a loop with its
state columns in registers (no block shares anything with another: each
value column of the state evolves on its own), and runs the serial
recurrence itself, which needs no exponentials; the Pallas kernel's chunked
closed form spends L²·K of them per chunk to feed the MXU.  The inputs are
read in their (B, T, H, K) layout, with no transposed copies.  r, k and v
are f32 or bf16, w and the state f32 (as the time mix passes them); ``u`` is
cast to f32 here (H x K values).  r, k, v, w and the state must be
contiguous.

A CPU tensor takes the plain version, :func:`plain`
(``ref.rwkv6_scan_chunked``, which is what ``chunk`` is for); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import rwkv6_scan_chunked as plain

HEAD_DIMS = (8, 16, 64)  # the K instances the source compiles


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, T, H, V) in r's dtype, final state (B, H, K, V) f32)."""
    if r.device.type == "cpu":
        return plain(r, k, v, w, u, state, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)} and v {tuple(v.shape)} must be 4-d")
    B, T, H, K = r.shape
    V = v.shape[-1]
    want = {"k": (B, T, H, K), "v": (B, T, H, V), "w": (B, T, H, K), "u": (H, K),
            "state": (B, H, K, V)}
    got = {"k": k, "v": v, "w": w, "u": u, "state": state}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(got[name].shape)}, expected {shape}")
    if K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim K={K} not in {HEAD_DIMS}")
    if r.dtype not in _build.DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv6_scan: dtypes r {r.dtype} k {k.dtype} v {v.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan: dtypes w {w.dtype} state {state.dtype} (both f32)")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state)):
        if t.device != r.device or (name != "u" and not t.is_contiguous()):
            raise ValueError(f"rwkv6_scan: {name} must be contiguous on {r.device}")
    out = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    uf = u.float().contiguous()
    lib, fn = _entry()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uf.data_ptr(),
             state.data_ptr(), out.data_ptr(), s_out.data_ptr(), _build.DTYPE_CODES[r.dtype],
             B, T, H, K, V, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "rwkv6_scan")
    LAUNCHES["rwkv6_scan"] += 1
    return out, s_out
