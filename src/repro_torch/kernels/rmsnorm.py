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

Its backward K3b (:func:`rmsnorm_bwd`, ``rmsnorm_bwd_fused`` in the same
source) gives dx and dscale in one launch.  Bytes bound it too: x and dy
read once, dx written once (smollm-360m's (8192, 960) bf16: 47 MB, 0.014
ms at 3.35 TB/s).  :func:`bwd_plan` gives a persistent grid whose blocks
take contiguous runs of rows; a row is spread over a power of two of lanes
that own the same columns of every row, so (1 + scale) is read once and
the dscale partials stay in registers, and each lane issues its next
row's loads before this row's arithmetic, so x and dy cross device memory
once.  Each block writes one row of dscale partials; the last
``BWD_JOINERS`` blocks to arrive split dscale's columns and sum every row
in a fixed order: no float atomics, no second kernel, no memset (dscale
comes from ``torch.empty``).  The arrival tickets come from counters kept
per stream (:func:`counters`), so launches on two streams may overlap.
Rows of up to D 8192 (32 elements a lane).  ``ops.rmsnorm`` is the
``torch.autograd.Function`` that runs K3 and K3b.  :func:`previous_bwd`
keeps the previous design (``rmsnorm_bwd_v1``) for timing beside it.

A CPU tensor takes the plain versions, :func:`plain` (``ref.rmsnorm_ref``)
and ``ref.rmsnorm_bwd_ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import rmsnorm_bwd_ref
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


BWD_THREADS = 256        # threads of a K3b block (kBwdThreads)
BWD_REG_FLOATS = 32      # (1 + scale) values a lane holds, and as many dscale partials, at most
BWD_JOINERS = 32         # the last blocks to arrive, which sum dscale's columns (kJoiners)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """K3b's launch: ``grid`` blocks of ``BWD_THREADS``, one an SM, each a
    contiguous run of rows and one row of f32 dscale partials; a row spread
    over ``lanes`` lanes, ``chunks`` 16-byte chunks a lane."""
    rows: int
    D: int
    itemsize: int
    lanes: int
    chunks: int
    grid: int

    @property
    def groups(self) -> int:
        """Row groups of ``lanes`` lanes a block: each takes every
        ``groups``-th row of the block's run."""
        return BWD_THREADS // self.lanes

    @property
    def per_chunk(self) -> int:
        return CHUNK_BYTES // self.itemsize

    @property
    def reg_floats(self) -> int:
        """(1 + scale) values a lane holds in registers, and as many dscale
        partials."""
        return self.chunks * self.per_chunk

    def join_segments(self) -> list[range]:
        """The runs of the blocks' rows of partials whose sums join, in
        order, into each column of dscale: the kernel's last ``BWD_JOINERS``
        blocks split the columns (16 bytes each) between them, and a
        joiner's threads split the rows into as many runs as its share of
        columns leaves threads."""
        n, joiners = self.grid, min(BWD_JOINERS, self.grid)
        per = -(-(self.D // 4) // joiners)
        nseg = max(1, min(n, BWD_THREADS // min(per, BWD_THREADS)))
        seg = -(-n // nseg)
        return [range(k * seg, min(n, (k + 1) * seg)) for k in range(nseg)]

    def block_rows(self, block: int) -> range:
        """The contiguous run of rows ``block`` takes."""
        q, extra = divmod(self.rows, self.grid)
        start = block * q + min(block, extra)
        return range(start, start + q + (block < extra))

    def group_rows(self, block: int, group: int) -> range:
        """The rows a group of ``block`` takes, in the order it takes them."""
        return self.block_rows(block)[group::self.groups]

    def columns(self, thread: int) -> list[int]:
        """The elements of every row that ``thread`` of a block owns."""
        li, e = thread % self.lanes, self.per_chunk
        return [c * e + j for c in range(li, self.lanes * self.chunks, self.lanes)
                for j in range(e) if c * e + j < self.D]


def bwd_plan(rows: int, D: int, itemsize: int, n_sm: int) -> BwdPlan:
    """K3b's plan, a pure function of the shapes: a row of C 16-byte chunks
    gets the power of two of lanes that gives each ``ROW_CHUNKS`` (up to
    ``BWD_THREADS`` lanes; then more chunks a lane, up to
    ``BWD_REG_FLOATS`` elements, so D 8192 at most in f32 and bf16); the
    grid is the blocks the rows fill, one an SM at most."""
    per = CHUNK_BYTES // itemsize if itemsize in (2, 4) else 0
    if rows < 1 or D < 1 or not per or D % per:
        raise ValueError(f"rmsnorm_bwd: no plan for {rows} rows of {D} x {itemsize} bytes")
    n_chunks = D // per
    lanes = min(BWD_THREADS, _pow2(-(-n_chunks // ROW_CHUNKS)))
    chunks = _pow2(-(-n_chunks // lanes))
    if chunks * per > BWD_REG_FLOATS:
        raise ValueError(f"rmsnorm_bwd: D={D} is wider than one block holds (8192 at most)")
    return BwdPlan(rows, D, itemsize, lanes, chunks, min(-(-rows // (BWD_THREADS // lanes)), n_sm))


# K3b's ticket counters (blocks arrived, joiners done), one pair a (device,
# stream): launches on one stream run one after another, so only launches
# that cannot overlap share a pair
_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def counters(device: torch.device, stream: int) -> torch.Tensor:
    """The two u32 counters that K3b's launches on ``stream`` of ``device``
    take tickets from: zeroed by the stream's first call, and left at 0 by
    each launch's last joiner (so a CUDA graph replays with them too)."""
    key = (device, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def previous_bwd_launch(rows: int, D: int, n_sm: int) -> tuple[int, int]:
    """(warps a block, grid) of the previous K3b's ``rmsnorm_bwd_rows``: a
    warp's f32 row of D partials each in 64 KB, two blocks an SM."""
    warps = min(8, (64 << 10) // (4 * D))
    return warps, min(-(-rows // warps), 2 * n_sm)


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr, ctypes._CFuncPtr, ctypes._CFuncPtr]:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    floor = lib.launch_floor
    floor.argtypes = [ctypes.c_void_p]
    floor.restype = ctypes.c_int
    bwd = lib.rmsnorm_bwd
    bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    v1 = lib.rmsnorm_bwd_v1  # the previous K3b, for previous_bwd
    v1.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    v1.restype = ctypes.c_int
    return lib, fn, floor, bwd


def launch_floor(device: torch.device | None = None) -> None:
    """Launch an empty kernel of one block through the same route as K3: the
    card's fixed cost of a launch, which ``chip_smoke.py`` times beside K3.
    The port's main path never calls it, and it counts no launch."""
    lib, _, floor, _ = _entry()
    _build.check(lib, floor(torch.cuda.current_stream(device).cuda_stream), "launch_floor")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) f32.  (1 + scale) RMSNorm, f32 math, x's dtype out."""
    if x.device.type == "cpu":
        return plain(x, scale, eps=eps)
    refuse_grad("rmsnorm", "ops.rmsnorm differentiates through K3b", x, scale)
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
        lib, fn, _, _ = _entry()
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
                 rows, D, p.lanes, p.threads, p.chunks, float(eps),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "rmsnorm")
        LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """K3b: x, dy (..., D) of one dtype; scale (D,) f32 -> (dx in x's dtype,
    dscale (D,) f32), the gradients of :func:`rmsnorm` for output grad dy.
    On the card D * itemsize must be a multiple of 16 and D at most 8192
    (:func:`bwd_plan` raises ValueError beyond)."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, dy, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: no kernel for device {x.device}")
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm_bwd: scale must be f32 ({D},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if x.dtype not in DTYPES or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: x {x.dtype} {tuple(x.shape)}, dy {dy.dtype} "
                         f"{tuple(dy.shape)}")
    for name, t in (("x", x), ("scale", scale), ("dy", dy)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % CHUNK_BYTES:
            raise ValueError(f"rmsnorm_bwd: {name} must be contiguous on {x.device} and start "
                             "on a 16-byte boundary")
    if D * x.element_size() % CHUNK_BYTES:
        raise ValueError(f"rmsnorm_bwd: rows of {D} x {x.element_size()} bytes are not whole "
                         "16-byte chunks")
    dx = torch.empty_like(x)
    rows = x.numel() // D
    if not rows:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    p = bwd_plan(rows, D, x.element_size(), _build.sm_count(x.device.index))
    dscale = torch.empty(D, dtype=torch.float32, device=x.device)
    partial = torch.empty((p.grid, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count = counters(x.device, stream)
    lib, _, _, fn = _entry()
    err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
             dscale.data_ptr(), count.data_ptr(), _build.DTYPE_CODES[x.dtype], rows, D, p.lanes,
             p.chunks, p.grid, float(eps), stream)
    _build.check(lib, err, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale


def previous_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The previous K3b (``rmsnorm_bwd_rows`` + ``rmsnorm_bwd_dscale``, C
    entry ``rmsnorm_bwd_v1``) on CUDA tensors as :func:`rmsnorm_bwd` takes
    them, with its memset of dscale: ``chip_smoke.py`` and
    ``tools/k3b_variants.py`` time it beside the kernel.  The port never
    calls it, and it counts no launch."""
    D = x.shape[-1]
    rows = x.numel() // D
    warps, grid = previous_bwd_launch(rows, D, _build.sm_count(x.device.index))
    dx = torch.empty_like(x)
    dscale = torch.zeros(D, dtype=torch.float32, device=x.device)
    partial = torch.empty((grid, D), dtype=torch.float32, device=x.device)
    lib = _entry()[0]
    err = lib.rmsnorm_bwd_v1(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                             partial.data_ptr(), dscale.data_ptr(), _build.DTYPE_CODES[x.dtype],
                             rows, D, warps, grid, float(eps),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rmsnorm_bwd_v1")
    return dx, dscale
