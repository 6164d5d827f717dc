"""RMSNorm (kernel K3): CUDA C++ for Hopper, ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``): (1 + scale) RMSNorm over rows, f32 math, the output
in x's dtype.

What bounds it on the card: it reads x once and writes y once, with no
matrix work, so bytes bound it; at the served shapes (8 or 512 rows of 16
to 8192) it moves 14 KB to 16.8 MB, and below a megabyte the card's fixed
cost of one launch dominates (``launch_floor``, an empty kernel that
``chip_smoke.py`` times beside K3).  :func:`norm_plan` spreads each row
over a power-of-two number of lanes so that its 16-byte chunks span them:
narrow rows pack several to a warp, rows of up to 128 chunks (bf16 d 1024)
take one warp and reduce by shuffles only, wider rows (and decode rows,
which are few) take a few warps and one shared-memory step.  Each lane issues its loads
of x and of the scale into registers before any arithmetic, so one trip to
device memory serves both.  x is f32 or bf16 and contiguous; the scale f32
(D,).  Rows off 16 bytes load element by element.

A CPU tensor takes the plain version, :func:`plain` (``ref.rmsnorm_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ref import rmsnorm_ref as plain

DTYPES = (torch.float32, torch.bfloat16)

CHUNK_BYTES = 16        # one load of x a lane issues
MAX_CHUNKS = 8          # chunks a lane holds (the kernel's instances: 1, 2, 4, 8)
ROW_CHUNKS = 4          # chunks a lane takes where MAX_LANES allows
MIN_CHUNKS = 2          # few rows are spread over more lanes down to this many
BLOCK_THREADS = 128     # threads of a block of rows that fit one warp, at most
MAX_LANES = 256         # kMaxThreads: lanes of a row, at most


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class NormPlan:
    rows: int
    D: int
    itemsize: int
    lanes: int         # per row, a power of two
    chunks: int        # 16-byte chunks a lane holds
    threads: int       # per block: whole warps
    rows_per_block: int
    grid: int

    @property
    def per_chunk(self) -> int:
        return CHUNK_BYTES // self.itemsize

    def elements(self, block: int, thread: int) -> tuple[int | None, list[int]]:
        """(row, elements of it) that ``thread`` of ``block`` holds, as the
        kernel maps them (a row past ``rows`` is None)."""
        row = block * self.rows_per_block + thread // self.lanes
        li, e = thread % self.lanes, self.per_chunk
        cols = [c * e + j for c in range(li, self.lanes * self.chunks, self.lanes)
                for j in range(e) if c * e + j < self.D]
        return (row if row < self.rows else None), cols


def norm_plan(rows: int, D: int, itemsize: int, n_sm: int) -> NormPlan:
    """The kernel's plan, a pure function of the shapes: a row of up to 32
    16-byte chunks gets one lane a chunk (a power of two of them), a wider
    one the lanes (a power of two, at least a warp, at most ``MAX_LANES``)
    that give each ``ROW_CHUNKS`` chunks, or up to ``MAX_CHUNKS`` where
    ``MAX_LANES`` do not suffice; then, while the rows take fewer warps
    than the card has SMs, a row's lanes double (down to ``MIN_CHUNKS`` a
    lane).  A row wider than a warp takes one block; rows of a warp or less
    pack ``BLOCK_THREADS`` threads to a block, fewer while that leaves SMs
    without a block."""
    if rows < 1 or D < 1 or itemsize not in (2, 4):
        raise ValueError(f"rmsnorm: no plan for {rows} rows of {D} x {itemsize} bytes")
    per = CHUNK_BYTES // itemsize
    n_chunks = -(-D // per)
    lanes = (_pow2(n_chunks) if n_chunks <= 32
             else min(MAX_LANES, max(32, _pow2(-(-n_chunks // ROW_CHUNKS)))))
    chunks = _pow2(-(-n_chunks // lanes))
    if chunks > MAX_CHUNKS:
        raise ValueError(f"rmsnorm: D={D} is wider than one block holds")
    while (lanes >= 32 and chunks > MIN_CHUNKS and rows * lanes // 32 < n_sm
           and lanes < MAX_LANES):
        lanes, chunks = 2 * lanes, _pow2(-(-n_chunks // (2 * lanes)))
    threads = lanes
    if lanes <= 32:
        threads = BLOCK_THREADS
        while threads > max(lanes, 32) and -(-rows // (threads // lanes)) < n_sm:
            threads //= 2
    per_block = threads // lanes
    return NormPlan(rows, D, itemsize, lanes, chunks, threads, per_block, -(-rows // per_block))


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr, ctypes._CFuncPtr]:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    floor = lib.launch_floor
    floor.argtypes = [ctypes.c_void_p]
    floor.restype = ctypes.c_int
    return lib, fn, floor


def launch_floor(device: torch.device | None = None) -> None:
    """Launch an empty kernel of one block through the same route as K3: the
    card's fixed cost of a launch, which ``chip_smoke.py`` times beside K3.
    The port's main path never calls it, and it counts no launch."""
    lib, _, floor = _entry()
    _build.check(lib, floor(torch.cuda.current_stream(device).cuda_stream), "launch_floor")


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
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        p = norm_plan(rows, D, x.element_size(), _build.sm_count(x.device.index))
        lib, fn, _ = _entry()
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
                 rows, D, p.lanes, p.threads, p.chunks, float(eps),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "rmsnorm")
        LAUNCHES["rmsnorm"] += 1
    return out
