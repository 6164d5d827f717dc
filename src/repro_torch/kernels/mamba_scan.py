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
set the bound.  One block per (batch, tile of channels) walks the whole of
T with the state in registers (channels share nothing but B_t and C_t); a
lane holds min(N, 8) of a channel's state values.  :func:`mamba_plan` gives
the tile: 128 threads, at most 128 registers a thread and a small
shared-memory ring, so that 4 blocks fit an SM and the batch-1 prefill's
256 blocks run in one wave.  The inputs reach shared memory through a
``cp.async`` ring of ``steps``-step stages, read in their (B, T, DI) /
(B, T, N) layout with no transposed copies; steps run in groups of
``GROUP``, whose exponentials issue back to back and whose C·h sums are
reduce-scattered over a channel's lanes.  x, dt, Bm and C are f32 or bf16 (one type), A, D and the
state f32; all must be contiguous.

A CPU tensor takes the plain version, :func:`plain`
(``ref.mamba_scan_chunked``, which is what ``chunk`` is for); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import mamba_scan_chunked as plain

STATE_SIZES = (4, 8, 16)  # the N instances the source compiles

# the tiling, as csrc/mamba_scan.cu fixes it
THREADS = 128         # kThreads: per block
MIN_BLOCKS = 4        # kMinBlocks: the register cap keeps this many blocks on an SM
MAX_VALUES = 8        # kMaxVPL: state values a lane holds, at most
GROUP = 8             # kS: steps whose C·h sums are reduced together
STAGES = 2            # kStages: ring depth
STAGE_BYTES = 4096    # kStageBytes: of x (and of dt) in one stage
SM_SMEM = 232448      # shared memory an SM gives its blocks (227 KB)
BLOCK_RESERVED = 1024  # shared memory the card keeps per block


@dataclasses.dataclass(frozen=True)
class MambaPlan:
    B: int
    DI: int
    N: int
    values: int         # state values a lane holds: min(N, MAX_VALUES)
    lanes: int          # per channel: N / values
    channels: int       # per block
    steps: int          # per ring stage
    stages: int         # ring depth
    group: int          # steps reduced together
    threads: int
    smem_bytes: int     # dynamic shared memory per block
    grid: tuple[int, int]  # (channel tiles, B)
    resident: int       # blocks an SM holds at once, at least
    waves: int          # of the grid over the card's SMs

    def channel(self, block: tuple[int, int], thread: int) -> tuple[int, int | None, range]:
        """(b, channel, state values) that ``thread`` of ``block`` holds, as
        the kernel maps them (a channel past DI is None)."""
        ch = block[0] * self.channels + thread // self.lanes
        g = thread % self.lanes
        return block[1], ch if ch < self.DI else None, range(g * self.values, (g + 1) * self.values)


def mamba_plan(B: int, DI: int, N: int, itemsize: int, n_sm: int) -> MambaPlan:
    """The kernel's plan, a pure function of the shapes: min(N, MAX_VALUES)
    state values a lane, N / that lanes a channel, so a block of THREADS
    takes THREADS / lanes channels; a ring stage holds STAGE_BYTES of x (and
    of dt), so its steps are STAGE_BYTES / (channels x itemsize);
    ``itemsize`` is x / dt / Bm / C's element size.
    ``resident`` is what the register cap and the shared memory leave an SM,
    and ``waves`` how many times the grid fills the card's ``n_sm`` SMs."""
    if N not in STATE_SIZES or itemsize not in (2, 4):
        raise ValueError(f"mamba_scan: no plan for N={N}, itemsize {itemsize}")
    values = min(N, MAX_VALUES)
    lanes = N // values
    ct = THREADS // lanes
    steps = STAGE_BYTES // (ct * itemsize)
    smem = STAGES * steps * (2 * ct + 2 * N) * itemsize  # the ring, in the inputs' type
    if itemsize == 2:
        smem += 2 * steps * N * 4  # a bf16 stage's B and C rows in f32
    resident = min(MIN_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVED))
    grid = (-(-DI // ct), B)
    return MambaPlan(B, DI, N, values, lanes, ct, steps, STAGES, GROUP, THREADS, smem, grid,
                     resident, -(-grid[0] * grid[1] // (n_sm * resident)))


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    refuse_grad("mamba_scan", "its backward kernel is ROADMAP item K5b", x, dt, A, Bm, C, D,
                state)
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
    p = mamba_plan(B, DI, N, x.element_size(), _build.sm_count(x.device.index))
    lib, fn = _entry()
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
             D.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
             _build.DTYPE_CODES[x.dtype], B, T, DI, N, p.channels, p.steps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y, s_out
