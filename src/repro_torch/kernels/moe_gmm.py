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

K4b, the backward (``csrc/moe_gmm_bwd.cu``), is three kernels with one
wrapper each, every launch counted under ``LAUNCHES["moe_gmm_bwd"]``:
:func:`gated_dgrad` (dh = dy w2^T with the gated FFN's derivative in its
epilogue), :func:`dgrad` (dx = g w^T, or the sum of two such products in
one accumulator) and :func:`wgrad` (dw = x^T g over the capacity rows).
At deepseek-moe-16b's training shape (a) is bound by bytes, (b) and (c)
by operations.  In bf16, where D and F are multiples of 8 and the
operands 16-byte aligned, they run as two wgmma kernels fed by TMA,
warp-specialised and persistent (``gmm_dgrad_sm90<EPI>`` for (a) and (b),
``gmm_wgrad_sm90`` for (c); their tiles, shared memory and walk in
``plan.py``); other bf16 operands take ``mma.sync`` with element-wise
loads, and f32 the CUDA cores (:func:`bwd_instance`).  A CPU tensor takes the plain versions
(``ref.gmm_gated_dgrad_ref``, ``ref.gmm_dgrad_ref``,
``ref.gmm_wgrad_ref``).  ``ops.moe_ffn`` and ``ops.gmm`` differentiate
through them (``ops.MoEFFN``, ``ops.GMM``).  :func:`previous_bwd` runs the
first design's bf16 ``cp.async`` instances, for timing only.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, plan, refuse_grad
# gmm_mma's tiling and its plan, as csrc/moe_gmm.cu fixes them
from repro_torch.kernels.plan import (BK, BLOCK_SMEM, BN, MAX_ROW_TILES, PAD,  # noqa: F401
                                      ROW_TILE, ROW_TILES_BUILT, STAGES, TilePlan, stage_bytes,
                                      tile_plan)
from repro_torch.kernels import ref
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


def _entries(lib: ctypes.CDLL, spec: dict[str, tuple[int, int]]) -> list:
    """``lib``'s C entry points of ``spec`` (name: (pointers, ints)), each
    taking its pointers, its ints and the stream, returning an error code."""
    out = []
    for name, (ptrs, ints) in spec.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out.append(fn)
    return out


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr, ctypes._CFuncPtr]:
    lib = _build.load("moe_gmm")
    fn, mma = _entries(lib, {"moe_gmm_fwd": (3, 6), "moe_gmm_mma_fwd": (3, 7)})
    return lib, fn, mma


# the C entry points of each K4b kernel (pointers, ints), and of the first
# design's bf16 cp.async instances under the same arguments (*_v1)
_BWD_ENTRIES = {"gated": ("moe_gmm_bwd_gated", 6, 6), "dgrad": ("moe_gmm_bwd_dgrad", 5, 5),
                "wgrad": ("moe_gmm_bwd_wgrad", 3, 5)}


@functools.cache
def _bwd_entry() -> tuple[ctypes.CDLL, dict[str, ctypes._CFuncPtr]]:
    lib = _build.load("moe_gmm_bwd")
    spec = {f"{name}{v}": (ptrs, ints) for name, ptrs, ints in _BWD_ENTRIES.values()
            for v in ("", "_v1")}
    fns = dict(zip(spec, _entries(lib, spec)))
    lib.moe_gmm_bwd_sm90_config.argtypes = [ctypes.c_void_p]
    lib.moe_gmm_bwd_sm90_config.restype = ctypes.c_int
    return lib, fns


# what moe_gmm_bwd_sm90_config reports of the wgmma instances
SM90_CONFIG_KEYS = ("entry_regs_gated", "entry_regs_store", "regs_silu", "regs_gelu",
                    "regs_store", "regs_wgrad", "smem_gated", "smem_store", "blocks_per_sm_gated",
                    "blocks_per_sm_store", "blocks_per_sm_wgrad", "tile_m_gated", "tile_m_store",
                    "tile_n", "tile_k", "stages_gated", "stages_store", "sm_count")
_SM90_CONFIGS: dict[int, dict[str, int]] = {}


def sm90_config(device: int) -> dict[str, int]:
    """K4b's wgmma instances as built, on CUDA device ``device`` (queried
    once): the entry registers each one's setmaxnreg exchange assumes and
    the registers ptxas gave it, their shared memory, blocks an SM, tiles
    and ring stages, and the SM count that sizes the grid.  Raises if ptxas
    gave an instance another register count than its entry count (its
    consumers would wait forever), or if the source's tiles, stages or
    shared memory differ from ``plan.py``'s mirror."""
    cfg = _SM90_CONFIGS.get(device)
    if cfg is None:
        _build.refuse_in_capture(f"the wgmma K4b configuration query {_build.EAGER_FIRST}")
        lib = _bwd_entry()[0]
        out = (ctypes.c_int * len(SM90_CONFIG_KEYS))()
        with torch.cuda.device(device):
            err = lib.moe_gmm_bwd_sm90_config(out)
        got = dict(zip(SM90_CONFIG_KEYS, out))
        regs = {k: (got[k], got["entry_regs_" + ("gated" if k in ("regs_silu", "regs_gelu")
                                                  else "store")])
                for k in ("regs_silu", "regs_gelu", "regs_store", "regs_wgrad")}
        if all(r >= 0 for r, _ in regs.values()) and any(r != w for r, w in regs.values()):
            raise RuntimeError(f"moe_gmm_bwd: ptxas gave the wgmma kernels (registers, entry "
                               f"count) {regs}: setmaxnreg's exchange needs the entry count")
        _build.check(lib, err, "moe_gmm_bwd")
        mirror = {"entry_regs_gated": plan.bwd_entry_regs("silu"),
                  "entry_regs_store": plan.bwd_entry_regs("store"),
                  "smem_gated": plan.bwd_smem("silu"), "smem_store": plan.bwd_smem("store"),
                  "tile_m_gated": plan.bwd_tile_m("silu"), "tile_m_store": plan.bwd_tile_m("store"),
                  "tile_n": plan.BWD_TILE_N, "tile_k": plan.BWD_TILE_K,
                  "stages_gated": plan.BWD_DESIGN["silu"][1],
                  "stages_store": plan.BWD_DESIGN["store"][1]}
        if any(got[k] != v for k, v in mirror.items()):
            raise RuntimeError(f"moe_gmm_bwd: the source's design {got} differs from plan.py's "
                               f"{mirror}")
        cfg = _SM90_CONFIGS[device] = got
    return cfg


def gmm(x: torch.Tensor, w: torch.Tensor, *, epilogue: Optional[str] = None,
        max_row_tiles: int = MAX_ROW_TILES) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, f32 accumulation.
    ``max_row_tiles`` caps gmm_mma's row tiles a block (:func:`tile_plan`);
    the other instances and the plain version ignore it."""
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"moe_gmm: epilogue {epilogue!r} not in {list(EPILOGUE_CODES)}")
    if x.device.type == "cpu":
        return plain(x, w, epilogue=epilogue)
    refuse_grad("moe_gmm", "ops.gmm and ops.moe_ffn differentiate it (through K4b)", x, w)
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


# ---------------------------------------------------------------------------
# K4b: the backward kernels
# ---------------------------------------------------------------------------


def bwd_instance(dtype: torch.dtype, D: int, F: int, aligned: bool) -> str:
    """The instance a K4b launch takes (the same rule in all three kernels):
    a function of dtype, shape and alignment (every operand at a 16-byte
    boundary) only."""
    if dtype == torch.float32:
        return "f32"
    if D % 8 == 0 and F % 8 == 0 and aligned:
        return "bf16 wgmma"
    return "bf16 element-wise"


def _bwd_checks(what: str, named: dict[str, tuple[torch.Tensor, tuple[int, ...]]]) -> None:
    """Raise unless every tensor of ``named`` (name: (tensor, its shape))
    has its shape, is contiguous, and shares the first one's device and
    dtype, which a K4b kernel takes; and, under grad mode, unless none
    needs a gradient (K4b has no backward of its own)."""
    tensors = [t for t, _ in named.values()]
    refuse_grad("moe_gmm_bwd", "it is the backward of ops.moe_ffn / ops.gmm, and has no "
                "backward itself", *tensors)
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {first.device}")
    if first.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {first.dtype}")
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != first.device or t.dtype != first.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {first.dtype} tensor on "
                             f"{first.device}")


def _bwd_launch(what: str, entry: str, previous: bool, *args) -> None:
    """Launches C entry ``entry`` (its ``_v1`` twin, uncounted, for
    ``previous``: the first design's instances)."""
    lib, fns = _bwd_entry()
    _build.check(lib, fns[entry + ("_v1" if previous else "")](*args), what)
    if not previous:
        LAUNCHES["moe_gmm_bwd"] += 1


def gated_dgrad(dy: torch.Tensor, w2: torch.Tensor, a1: torch.Tensor, a3: torch.Tensor,
                act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """K4b (a): dy (E, C, D), w2 (E, F, D), the pre-activation a1 and a3
    (E, C, F) -> (da1, da3), dh = dy w2^T in f32 and da1 = dh a3 act'(a1),
    da3 = dh act(a1), each rounded once (``ref.gmm_gated_dgrad_ref``)."""
    if act not in ("silu", "gelu"):
        raise ValueError(f"moe_gmm_bwd: act {act!r} not in ['silu', 'gelu']")
    if dy.device.type == "cpu":
        return ref.gmm_gated_dgrad_ref(dy, w2, a1, a3, act)
    return _gated_dgrad(dy, w2, a1, a3, act, False)


def _gated_dgrad(dy, w2, a1, a3, act: str, previous: bool) -> tuple[torch.Tensor, torch.Tensor]:
    E, C, D = dy.shape
    F = w2.shape[1]
    _bwd_checks("moe_gmm_bwd (a)", {"dy": (dy, (E, C, D)), "w2": (w2, (E, F, D)),
                                    "a1": (a1, (E, C, F)), "a3": (a3, (E, C, F))})
    da1, da3 = torch.empty_like(a1), torch.empty_like(a3)
    if da1.numel() == 0:
        return da1, da3
    if D == 0:
        return da1.zero_(), da3.zero_()
    _bwd_launch("moe_gmm_bwd (a)", "moe_gmm_bwd_gated", previous, dy.data_ptr(), w2.data_ptr(),
                a1.data_ptr(), a3.data_ptr(), da1.data_ptr(), da3.data_ptr(),
                _build.DTYPE_CODES[dy.dtype], EPILOGUE_CODES[act], E, C, D, F,
                torch.cuda.current_stream(dy.device).cuda_stream)
    return da1, da3


def dgrad(g: torch.Tensor, w: torch.Tensor, g2: Optional[torch.Tensor] = None,
          w2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4b (b): g (E, C, F), w (E, D, F) -> g w^T (E, C, D), plus g2 w2^T
    in the same f32 accumulator when given; one rounding
    (``ref.gmm_dgrad_ref``)."""
    if (g2 is None) != (w2 is None):
        raise ValueError("moe_gmm_bwd: g2 and w2 go together")
    if g.device.type == "cpu":
        return ref.gmm_dgrad_ref(g, w, g2, w2)
    return _dgrad(g, w, g2, w2, False)


def _dgrad(g, w, g2, w2, previous: bool) -> torch.Tensor:
    E, C, F = g.shape
    D = w.shape[1]
    named = {"g": (g, (E, C, F)), "w": (w, (E, D, F))}
    if g2 is not None:
        named.update(g2=(g2, (E, C, F)), w2=(w2, (E, D, F)))
    _bwd_checks("moe_gmm_bwd (b)", named)
    out = torch.empty((E, C, D), dtype=g.dtype, device=g.device)
    if out.numel() == 0 or F == 0:
        return out.zero_()
    _bwd_launch("moe_gmm_bwd (b)", "moe_gmm_bwd_dgrad", previous, g.data_ptr(), w.data_ptr(),
                None if g2 is None else g2.data_ptr(), None if w2 is None else w2.data_ptr(),
                out.data_ptr(), _build.DTYPE_CODES[g.dtype], E, C, D, F,
                torch.cuda.current_stream(g.device).cuda_stream)
    return out


def wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4b (c): a (E, C, P), b (E, C, Q) -> a^T b (E, P, Q), summed over the
    C capacity rows in f32, one rounding (``ref.gmm_wgrad_ref``)."""
    if a.device.type == "cpu":
        return ref.gmm_wgrad_ref(a, b)
    return _wgrad(a, b, False)


def _wgrad(a, b, previous: bool) -> torch.Tensor:
    E, C, P = a.shape
    Q = b.shape[2]
    _bwd_checks("moe_gmm_bwd (c)", {"a": (a, (E, C, P)), "b": (b, (E, C, Q))})
    out = torch.empty((E, P, Q), dtype=a.dtype, device=a.device)
    if out.numel() == 0 or C == 0:
        return out.zero_()
    _bwd_launch("moe_gmm_bwd (c)", "moe_gmm_bwd_wgrad", previous, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), _build.DTYPE_CODES[a.dtype], E, C, P, Q,
                torch.cuda.current_stream(a.device).cuda_stream)
    return out


def previous_bwd(kernel: str, *tensors: torch.Tensor, act: str = "silu"):
    """K4b's first design, the bf16 ``cp.async`` / ``mma.sync`` instances
    (C entries ``moe_gmm_bwd_*_v1``), on the tensors the wrapper
    ``kernel`` ("gated_dgrad", "dgrad" or "wgrad") takes: bf16 CUDA
    tensors whose D and F are multiples of 8, 16-byte aligned (the C entry
    refuses others).  ``chip_smoke.py`` and ``tools/moe_train_phase.py``
    time it beside the kernels.  The port never calls it, and it counts no
    launch."""
    if kernel not in ("gated_dgrad", "dgrad", "wgrad"):
        raise ValueError(f"previous_bwd: kernel {kernel!r} is not gated_dgrad, dgrad or wgrad")
    if any(t.device.type != "cuda" or t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"previous_bwd: bf16 CUDA tensors only, got "
                         f"{[f'{t.dtype} on {t.device}' for t in tensors]}")
    if kernel == "gated_dgrad":
        return _gated_dgrad(*tensors, act, True)
    if kernel == "dgrad":
        g, w, g2, w2 = (*tensors, None, None)[:4]
        return _dgrad(g, w, g2, w2, True)
    return _wgrad(*tensors, True)
