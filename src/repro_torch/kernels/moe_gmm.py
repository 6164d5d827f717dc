"""Grouped expert matmul (kernel K4): CUDA C++ for Hopper, ``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py`` (``gmm`` /
``_gmm_kernel``): ``(E, C, D) @ (E, D, F) -> (E, C, F)``, one matmul per
expert over its capacity bucket, f32 accumulation, and an optional fused
``silu`` / tanh-``gelu`` epilogue on the f32 accumulator before the one
rounding to x's dtype.

What bounds it on the card: bytes.  A call streams every expert's weights
(6.4 GB at jamba-1.5-large's shapes, ~1.95 ms at 3.35 TB/s; 369 MB at
deepseek-moe-16b's), and its products take a fraction of that on the tensor
cores.  So each weight element must cross device memory once, with enough
bytes in flight per SM to cover the memory's latency, and the products must
overlap the stream.

Three instances, chosen by :func:`instance` from dtype, shape and alignment
only:

* ``gmm_mma`` (bf16, D and F multiples of 8, 16-byte aligned x and w): one
  block per (expert, 256-column F tile, all C rows), the rows in 16-row
  ``mma.sync`` m16n8k16 tiles (up to 8, 128 rows; a taller C splits into
  equal row blocks, :func:`tile_plan`), x and w through a 4-stage
  ``cp.async`` ring of 64-deep tiles, 8 warps of 32 columns that each hold
  every row tile, fragments fetched ahead of their mmas.
* ``gmm_bf16_kernel`` (bf16 otherwise, e.g. F = 12 or an unaligned view):
  64-row C tiles on WMMA, register-staged double buffering.
* ``gmm_f32_kernel`` (f32): the same blocking on the CUDA cores in full
  f32, exact to f32 rounding for the f32 end-to-end gates.

The ragged C / F / D edges are masked in the kernels.  A CPU tensor takes
the plain version, :func:`plain` (``ref.gmm_ref``); a CUDA tensor launches a
kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import gmm_ref as plain

EPILOGUE_CODES = {None: 0, "silu": 1, "gelu": 2}  # enum Epilogue in the source

# gmm_mma's tiling, as csrc/moe_gmm.cu fixes it
ROW_TILE = 16         # rows of one mma tile
MAX_ROW_TILES = 8     # kMaxRowTiles: row tiles one block holds
BN = 256              # kMmaBN: F columns per block (8 warps of 32)
BK = 64               # kMmaBK: depth of one ring stage along D
STAGES = 4            # kMmaStages: ring depth
PAD = 8               # bf16 of padding per shared-memory row (16 bytes)
BLOCK_SMEM = 232448   # the most shared memory one block can take (227 KB)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    row_tiles: int     # 16-row mma tiles per block
    row_blocks: int    # blocks along C
    bn: int            # F columns per block
    bk: int            # depth of one ring stage
    stages: int        # ring depth
    smem_bytes: int    # dynamic shared memory per block
    grid: tuple[int, int, int]  # (F tiles, row blocks, E), F fastest

    def rows(self, C: int) -> list[range]:
        """The C rows each row block covers."""
        h = ROW_TILE * self.row_tiles
        return [range(b * h, min(C, (b + 1) * h)) for b in range(self.row_blocks)]


def stage_bytes(row_tiles: int) -> int:
    """One ring stage: an x tile (rows x BK) and a w tile (BK x BN), padded."""
    return 2 * (ROW_TILE * row_tiles * (BK + PAD) + BK * (BN + PAD))


def tile_plan(E: int, C: int, F: int) -> TilePlan:
    """gmm_mma's plan, a pure function of the shapes: all C rows in one
    block where C <= 128, else the fewest row blocks of equal height, so
    every weight element is read from device memory once (or once per row
    block)."""
    tiles = -(-C // ROW_TILE)
    row_blocks = -(-tiles // MAX_ROW_TILES)
    row_tiles = -(-tiles // row_blocks)
    return TilePlan(row_tiles, row_blocks, BN, BK, STAGES, STAGES * stage_bytes(row_tiles),
                    (-(-F // BN), row_blocks, E))


def instance(dtype: torch.dtype, D: int, F: int, aligned: bool) -> str:
    """The kernel a launch runs: a function of dtype, shape and alignment
    (x and w at 16-byte boundaries) only."""
    if dtype == torch.float32:
        return "gmm_f32_kernel"
    if D % 8 == 0 and F % 8 == 0 and aligned:
        return "gmm_mma"
    return "gmm_bf16_kernel"


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr, ctypes._CFuncPtr]:
    lib = _build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mma = lib.moe_gmm_mma_fwd
    mma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    mma.restype = ctypes.c_int
    return lib, fn, mma


def gmm(x: torch.Tensor, w: torch.Tensor, *, epilogue: Optional[str] = None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, f32 accumulation."""
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"moe_gmm: epilogue {epilogue!r} not in {list(EPILOGUE_CODES)}")
    if x.device.type == "cpu":
        return plain(x, w, epilogue=epilogue)
    refuse_grad("moe_gmm", "its backward kernel is ROADMAP item K4b", x, w)
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
    lib, fn, mma = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if instance(x.dtype, D, F, aligned) == "gmm_mma":
        p = tile_plan(E, C, F)
        err = mma(x.data_ptr(), w.data_ptr(), out.data_ptr(), EPILOGUE_CODES[epilogue], E, C,
                  D, F, p.row_tiles, p.row_blocks, stream)
    else:
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
                 EPILOGUE_CODES[epilogue], E, C, D, F, stream)
    _build.check(lib, err, "moe_gmm")
    LAUNCHES["moe_gmm"] += 1
    return out
