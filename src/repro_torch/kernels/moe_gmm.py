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
  ``mma.sync`` m16n8k16 tiles (up to ``max_row_tiles``, 8 unless a caller
  or the tuner asks for another of 1-10; a taller C splits into equal row
  blocks, :func:`tile_plan`), x and w through a 4-stage
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
import functools
import re
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
# gmm_mma's tiling and its plan, as csrc/moe_gmm.cu fixes them
from repro_torch.kernels.plan import (BK, BLOCK_SMEM, BN, MAX_ROW_TILES, PAD,  # noqa: F401
                                      ROW_TILE, ROW_TILES_BUILT, STAGES, TilePlan, stage_bytes,
                                      tile_plan)
from repro_torch.kernels.ref import gmm_ref as plain

EPILOGUE_CODES = {None: 0, "silu": 1, "gelu": 2}  # enum Epilogue in the source


def instance(dtype: torch.dtype, D: int, F: int, aligned: bool) -> str:
    """The kernel a launch runs: a function of dtype, shape and alignment
    (x and w at 16-byte boundaries) only."""
    if dtype == torch.float32:
        return "gmm_f32_kernel"
    if D % 8 == 0 and F % 8 == 0 and aligned:
        return "gmm_mma"
    return "gmm_bf16_kernel"


def ptxas_report() -> dict[int, dict[str, int]]:
    """ptxas' report of each ``gmm_mma<MT, EPI>`` instance of the built
    library (``nvcc -Xptxas=-v``, kept beside it), per row-tile count MT:
    the most registers a thread and bytes of spill stores over its three
    epilogues.  Builds the library if it is not built yet."""
    _entry()
    text = _build.lib_path("moe_gmm").with_suffix(".log").read_text()
    out: dict[int, dict[str, int]] = {}
    for part in text.split("Compiling entry function '")[1:]:
        m = re.search(r"gmm_mmaILi(\d+)ELi\d+E", part.split("'")[0])
        if m is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        row = out.setdefault(int(m.group(1)), {"registers": 0, "spill_bytes": 0})
        row["registers"] = max(row["registers"], int(regs.group(1)) if regs else 0)
        row["spill_bytes"] = max(row["spill_bytes"], int(spill.group(1)) if spill else 0)
    return out


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


def gmm(x: torch.Tensor, w: torch.Tensor, *, epilogue: Optional[str] = None,
        max_row_tiles: int = MAX_ROW_TILES) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, f32 accumulation.
    ``max_row_tiles`` caps gmm_mma's row tiles a block (:func:`tile_plan`);
    the other instances and the plain version ignore it."""
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"moe_gmm: epilogue {epilogue!r} not in {list(EPILOGUE_CODES)}")
    if x.device.type == "cpu":
        return plain(x, w, epilogue=epilogue)
    refuse_grad("moe_gmm", "its backward kernel is ROADMAP Queue 2 item K4b", x, w)
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
        p = tile_plan(E, C, F, max_row_tiles)
        err = mma(x.data_ptr(), w.data_ptr(), out.data_ptr(), EPILOGUE_CODES[epilogue], E, C,
                  D, F, p.row_tiles, p.row_blocks, stream)
    else:
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
                 EPILOGUE_CODES[epilogue], E, C, D, F, stream)
    _build.check(lib, err, "moe_gmm")
    LAUNCHES["moe_gmm"] += 1
    return out
