"""RWKV6 WKV scan (kernel K6): CUDA C++ for Hopper, ``csrc/rwkv6_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``rwkv6_scan`` / ``_rwkv6_kernel``):

    out_t = r_t · (S_t + diag(u) k_t v_tᵀ);   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

with r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) and the state
(B, H, K, V) in f32; out in r's dtype, all arithmetic in f32.

What bounds it on the card: at the served prefill (B 1, T 512, 64 heads of
64) the work is ~27 MB and ~0.4 GFLOP of f32, ~8 us either way, but a
serial scan is held by the instructions each time step issues: there are
only 64 x 4096 state elements, 16 per lane of the card, so each SM runs
one warp per scheduler and has nothing to hide a stall behind (more warps
for the same work gain ~1.2x at most; ``tools/k6_variants.py``).  The
kernel runs the exact serial recurrence (no exponentials; the Pallas
kernel's chunked closed form spends L²·K of them per chunk to feed the
MXU) and cuts the instructions per state element: each thread holds a
``KT x VT`` tile of one head's state in registers for the whole sweep, so
every r / k / w value it reads from shared memory serves VT elements and
every v value KT; the u bonus is factored out of the columns
(``out = Σ_k r_k S[k, v] + v Σ_k r_k u_k k_k``: 3 FP operations per element
and step, not 4); the K sums of 8 time steps are reduced together by one
reduce-scatter butterfly over the K / KT lanes of a column;
and the inputs reach shared memory through a ``STAGES``-deep ``cp.async``
ring of ``STEPS``-step stages, read in their (B, T, H, K) layout with no
transposed copies.  :func:`scan_plan` sizes the grid to fill the card.
r, k and v are f32 or bf16, w and the state f32 (as the time mix passes
them); ``u`` f32 or bf16 (read as it is, so no cast runs in front of the
kernel; another dtype is cast to f32 here).  r, k, v, w and the state
must be contiguous.

A CPU tensor takes the plain version, :func:`plain`
(``ref.rwkv6_scan_chunked``, which is what ``chunk`` is for); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import rwkv6_scan_chunked as plain

HEAD_DIMS = (8, 16, 64)  # the K instances the source compiles

# the tiling, as csrc/rwkv6_scan.cu fixes it
KT = 4                # kKT: state rows a thread holds
VT = 4                # kVT: state columns a thread holds
STEPS = 32            # kSteps: time steps per ring stage
STAGES = 3            # kStages: ring depth
MAX_THREADS = 256     # kMaxThreads
COLUMN_TILES = (64, 32, 16)  # the columns a block may take, widest first


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    B: int
    H: int
    K: int
    V: int
    kt: int            # state rows a thread holds
    vt: int            # state columns a thread holds
    vb: int            # state columns a block holds
    threads: int       # per block: (K / kt) x (vb / vt)
    steps: int         # time steps per ring stage
    stages: int        # ring depth
    smem_bytes: int    # dynamic shared memory per block
    grid: tuple[int, int]  # (column tiles, B * H)

    def tile(self, block: tuple[int, int], thread: int) -> tuple[int, int, range, list[int]]:
        """(b, h, state rows, state columns) that ``thread`` of ``block``
        holds, as the kernel maps them (columns past V are masked off)."""
        g = self.K // self.kt
        b, h = divmod(block[1], self.H)
        kg, c0 = thread % g, block[0] * self.vb + thread // g * self.vt
        return (b, h, range(kg * self.kt, (kg + 1) * self.kt),
                [c for c in range(c0, c0 + self.vt) if c < self.V])


def scan_plan(B: int, H: int, K: int, V: int, n_sm: int, itemsize: int = 2) -> ScanPlan:
    """The kernel's plan, a pure function of the shapes: one block per
    (batch, head, tile of vb columns), vb the widest of COLUMN_TILES that
    gives the block whole warps (its shuffles take the full mask) and still
    gives each of the card's ``n_sm`` SMs a block (else the narrowest such
    width); ``itemsize`` is r / k / v's element size."""
    if K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim K={K} not in {HEAD_DIMS}")
    widths = [c for c in COLUMN_TILES if K // KT * (c // VT) % 32 == 0]
    vb = next((c for c in widths if B * H * -(-V // c) >= n_sm), widths[-1])
    smem = STAGES * STEPS * (K * (2 * itemsize + 4) + vb * itemsize)
    return ScanPlan(B, H, K, V, KT, VT, vb, K // KT * (vb // VT), STEPS, STAGES, smem,
                    (-(-V // vb), B * H))


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    refuse_grad("rwkv6_scan", "its backward kernel is ROADMAP item K6b", r, k, v, w, u, state)
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
    # u is read as it is in f32 or bf16 (no cast kernel in front of each call)
    uu = (u if u.dtype in _build.DTYPE_CODES else u.float()).contiguous()
    p = scan_plan(B, H, K, V, _build.sm_count(r.device.index), r.element_size())
    lib, fn = _entry()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uu.data_ptr(),
             state.data_ptr(), out.data_ptr(), s_out.data_ptr(), _build.DTYPE_CODES[r.dtype],
             _build.DTYPE_CODES[uu.dtype], B, T, H, K, V, p.vb,
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "rwkv6_scan")
    LAUNCHES["rwkv6_scan"] += 1
    return out, s_out
