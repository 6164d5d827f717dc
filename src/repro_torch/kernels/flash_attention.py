"""Flash attention (kernel K1): CUDA C++ for Hopper, ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_fa_kernel``): online-softmax attention with f32
m / l / acc, causal, sliding ``window``, ``q_offset`` and tanh ``softcap``,
GQA (query head h reads KV head h // G).

What bounds it on the card: at the serving shapes the bytes (q, k, v in and
out once) set the card's bound, and only the tensor cores come near it.  The
instance depends on dtype and head dim alone (:func:`instance`):

* bf16 at D 16 / 32 / 64 / 128 / 256 runs ``flash_fwd_mma``,
  FlashAttention-2 on the tensor cores (``mma.sync`` m16n8k16, 64 q rows a
  block, bf16 K / V tiles of 64 keys in a 2-stage ``cp.async`` ring, the
  online softmax in registers, P rounded to bf16 for P·V; at D 256, where
  O's accumulator is half of a thread's registers, tiles of 32 keys and
  Q's fragments read from shared memory at each k-step);
* f32, and bf16 at D 8, run ``flash_fwd_simt``, the products on the f32
  CUDA cores, exact to f32 rounding (the f32 end-to-end gates run it).

Both compute each q tile's KV range from causal / window / q_offset and mask
the ragged Sq / Sk edges themselves instead of padding copies.

With ``return_lse`` both also write each row's log-sum-exp (f32 (B, Hq,
Sq)), which the backward needs.  The backward, K1b
(:func:`flash_attention_bwd`), replaces ``repro/kernels/flash_vjp.py``'s
``_bwd_rule``: two passes, no atomics (dq and delta per q tile; dk and dv
per KV head and key tile, summed over its G query heads in the block).
Four instances, by dtype and head dim only (:func:`bwd_instances`), at
every head dim of K1; another head dim raises before any launch:

* bf16 at D 64, the training path's shape: ``flash_bwd_dq_wgmma`` +
  ``flash_bwd_dkdv_wgmma`` (``csrc/flash_attention_bwd_sm90.cu``), designed
  for Hopper: ``wgmma`` products, operands by TMA into mbarrier rings from
  a producer warpgroup, two consumer warpgroups of 64 rows (or keys) a
  block, a persistent grid whose blocks take the item lists of
  :func:`bwd_plan` (each item onto the least loaded block, longest first:
  causal items differ more than 10-fold in work at S 2048).  It is bound
  by the tensor cores: m64n64k16 products, 7 where a fused backward does 5;
* bf16 at D 128 / 256 (the gemmas, chameleon-34b, dbrx, deepseek-moe-16b):
  ``flash_bwd_dq_sm90`` + ``flash_bwd_dkdv_sm90`` (the same source,
  templated on D), the same design with one item of 64 rows (or keys) a
  block: its two consumer warpgroups split each 64 x 64 score tile by
  columns (m64n32k16 over D), share dS (P^T and dS^T) through shared memory
  and split the gradients' columns (m64n(D/2)k16), since a warpgroup cannot
  hold a 64-key tile's dK and dV at D 256.  Bound by the same 7 products,
  and at D 128 by the load stream where a KV head has many query heads
  (chameleon-34b's G 8) and by the special-function unit under a softcap
  (PERF.md); at D 256 rings of 2 stages (a 64-row tile is 32 KB) and a
  step that issues its own scores.  The previous design there,
  ``flash_bwd_dq_wide`` + ``flash_bwd_dkdv_wide`` (``mma.sync``,
  ``csrc/flash_attention_bwd.cu``), is reached only by
  :func:`previous_wide_bwd`, for timing;
* bf16 at D 16 / 32: ``flash_bwd_dq_mma`` + ``flash_bwd_dkdv_mma``
  (``csrc/flash_attention_bwd.cu``, ``mma.sync``);
* f32, and bf16 at D 8: ``flash_bwd_dq`` + ``flash_bwd_dkdv``, the f32
  CUDA cores (the f32 gates run it).

``ops.attention`` is the ``torch.autograd.Function`` that runs K1 and K1b.

A CPU tensor takes the plain versions, :func:`plain` (``ref.mha_ref``),
``ref.flash_attention_lse_ref`` and ``ref.flash_attention_bwd_ref``; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_lse_ref
from repro_torch.kernels.ref import mha_ref as plain

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the instances csrc/flash_attention.cu builds
MMA_HEAD_DIMS = (16, 32, 64, 128, 256)  # bf16 head dims on the tensor cores (multiples of 16)
BWD_HEAD_DIMS = HEAD_DIMS  # the instances of the backward sources
# bf16 head dims of K1b on mma.sync with a warp's whole rows (D 64, 128 and
# 256 take the wgmma instances of csrc/flash_attention_bwd_sm90.cu)
BWD_MMA_HEAD_DIMS = (16, 32)
BWD_WIDE_HEAD_DIMS = (128, 256)  # the wgmma instances whose warpgroups split D
BWD_SM90_HEAD_DIMS = (64, *BWD_WIDE_HEAD_DIMS)
# the kernels of the previous bf16 D 128 / 256 design, for timing only
PREVIOUS_WIDE_INSTANCES = ("flash_bwd_dq_wide", "flash_bwd_dkdv_wide")
BWD_TILE = 64  # rows (or keys) of a wgmma tile and of a consumer warpgroup
BWD_ITEM_COST = 1  # an item's own loads and stores, in tiles, for bwd_plan


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a launch runs: a function of dtype and head dim only."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "flash_fwd_mma"
    return "flash_fwd_simt"


def bwd_instances(dtype: torch.dtype, head_dim: int) -> tuple[str, str]:
    """The two kernels a K1b call runs: a function of dtype and head dim
    only.  A head dim without a backward instance raises."""
    if head_dim not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd: no backward kernel at head dim {head_dim} (instances at "
            f"{BWD_HEAD_DIMS})")
    if dtype == torch.bfloat16 and head_dim == 64:
        return "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"
    if dtype == torch.bfloat16 and head_dim in BWD_WIDE_HEAD_DIMS:
        return "flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90"
    if dtype == torch.bfloat16 and head_dim in BWD_MMA_HEAD_DIMS:
        return "flash_bwd_dq_mma", "flash_bwd_dkdv_mma"
    return "flash_bwd_dq", "flash_bwd_dkdv"


def bwd_walk(pass_: str, tile: int, *, Sq: int, Sk: int, wg: int, causal: bool,
             window: Optional[int], q_offset: int) -> tuple[int, int]:
    """The 64-tiles item ``tile`` of a wgmma K1b pass walks, as (first row or
    key, number of tiles), the kernels' ``Range`` (mirrors ``dq_keys`` /
    ``dkdv_rows`` in ``csrc/flash_attention_bwd_sm90.cu``): in ``"dq"`` the
    key tiles rows [64 wg tile, + 64 wg) can see, in ``"dkdv"`` the q tiles
    (of each query head) whose rows can see keys [64 wg tile, + 64 wg).  An
    item is ``wg`` 64-row tiles: 2 at D 64, 1 at D 128 / 256."""
    T = BWD_TILE
    if pass_ == "dq":
        row0 = tile * wg * T
        last = min(Sq, row0 + wg * T) - 1
        hi = min(Sk, q_offset + last + 1) if causal else Sk
        lo = max(0, q_offset + row0 - window + 1) if window is not None else 0
    elif pass_ == "dkdv":
        key0 = tile * wg * T
        last = min(Sk, key0 + wg * T) - 1
        lo = max(0, key0 - q_offset) if causal else 0
        hi = min(Sq, last + window - q_offset) if window is not None else Sq
    else:
        raise ValueError(f"bwd_walk: pass {pass_!r} is not 'dq' or 'dkdv'")
    start = lo // T * T
    return start, -(-(hi - start) // T) if hi > start else 0


def bwd_plan(pass_: str, B: int, Sq: int, Sk: int, Hq: int, Hkv: int, *, wg: int, slots: int,
             causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
             persistent: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """The item lists of a wgmma K1b pass: (offsets (blocks + 1,), items)
    int32; block i runs ``items[offsets[i]:offsets[i + 1]]`` in order.  An
    item is (b * H + h) * n_tiles + tile (H = Hq for ``"dq"``, Hkv for
    ``"dkdv"``; a tile is 64 wg rows or keys), and costs the tiles it walks
    (G of them per q tile in ``"dkdv"``) plus BWD_ITEM_COST.  Persistent:
    min(items, slots) blocks, the items longest first each onto the least
    loaded block (so no block exceeds the mean load by more than one item);
    otherwise one block per item, longest first."""
    cost = bwd_costs(pass_, B, Sq, Sk, Hq, Hkv, wg=wg, causal=causal, window=window,
                     q_offset=q_offset)
    order = np.argsort(-cost, kind="stable").astype(np.int32)  # longest first
    if not persistent:
        return np.arange(len(order) + 1, dtype=np.int32), order
    n_blocks = min(len(order), slots)
    heap = [(0, i) for i in range(n_blocks)]
    lists: list[list[int]] = [[] for _ in range(n_blocks)]
    for item in order:
        load, i = heapq.heappop(heap)
        lists[i].append(int(item))
        heapq.heappush(heap, (load + int(cost[item]), i))
    offsets = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    return offsets, np.array([x for lst in lists for x in lst], dtype=np.int32)


def bwd_costs(pass_: str, B: int, Sq: int, Sk: int, Hq: int, Hkv: int, *, wg: int,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> np.ndarray:
    """The cost :func:`bwd_plan` gives each item id of a pass."""
    H = Hq if pass_ == "dq" else Hkv
    n_tiles = -(-(Sq if pass_ == "dq" else Sk) // (wg * BWD_TILE))
    per_head = Hq // Hkv if pass_ == "dkdv" else 1
    walk = [per_head * bwd_walk(pass_, t, Sq=Sq, Sk=Sk, wg=wg, causal=causal, window=window,
                                q_offset=q_offset)[1] + BWD_ITEM_COST for t in range(n_tiles)]
    return np.tile(np.array(walk, dtype=np.int64), B * H)


@functools.cache
def _entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def instance_info(dtype: torch.dtype, head_dim: int, device: int = 0) -> dict[str, int]:
    """What the card made of the instance that ``dtype`` and ``head_dim``
    run (``_build.instance_info``)."""
    return _build.instance_info(_entry()[0], "flash_attention_fwd_info",
                                _build.DTYPE_CODES[dtype], head_dim, device=device)


@functools.cache
def _bwd_entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def sm90_library(lib: ctypes.CDLL) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """Binds a build of ``csrc/flash_attention_bwd_sm90.cu`` (the committed
    configuration, or one of ``tools/k1b_variants.py``'s)."""
    fn = lib.flash_attention_bwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_sm90_config.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd_sm90_config.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _sm90_entry() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    return sm90_library(_build.load("flash_attention_bwd_sm90"))


SM90_CONFIG_KEYS = ("wg_dq", "wg_dkdv", "stages", "blocks_per_sm_dq", "blocks_per_sm_dkdv",
                    "smem_dq", "smem_dkdv", "entry_regs_dq", "entry_regs_dkdv", "regs_dq",
                    "regs_dkdv", "regs_dq_cap", "regs_dkdv_cap", "head_dim", "item_tiles_dq",
                    "item_tiles_dkdv", "stages_dkdv", "item_bufs_dq", "item_bufs_dkdv",
                    "ahead")
_SM90_CONFIGS: dict[tuple[int, int, int], dict[str, int]] = {}
_PLANS: dict[tuple, tuple[torch.Tensor, int]] = {}


def sm90_config(lib: ctypes.CDLL, device: int, head_dim: int = 64) -> dict[str, int]:
    """A wgmma K1b build's instances at ``head_dim`` (64, 128 or 256):
    warpgroups a block, ring stages, the 64-row tiles of an item, the blocks
    of each pass an SM of CUDA device ``device`` holds, and the kernels'
    registers (queried once).  Raises if ptxas gave a kernel another entry
    register count than setmaxnreg's exchange assumes: it would hang."""
    cfg = _SM90_CONFIGS.get((id(lib), device, head_dim))
    if cfg is None:
        _build.refuse_in_capture(f"the wgmma K1b configuration query {_build.EAGER_FIRST}")
        out = (ctypes.c_int * len(SM90_CONFIG_KEYS))()
        with torch.cuda.device(device):
            err = lib.flash_attention_bwd_sm90_config(head_dim, out)
        got = dict(zip(SM90_CONFIG_KEYS, out))
        regs = {k: got[k] for k in ("regs_dq", "regs_dq_cap", "regs_dkdv", "regs_dkdv_cap")}
        want = {k: got["entry_regs_" + k.split("_")[1]] for k in regs}
        if all(r >= 0 for r in regs.values()) and regs != want:
            raise RuntimeError(f"flash_attention_bwd: ptxas gave the wgmma kernels at D "
                               f"{head_dim} {regs} registers a thread where setmaxnreg's "
                               f"exchange needs {want}")
        _build.check(lib, err, "flash_attention_bwd")
        cfg = _SM90_CONFIGS[(id(lib), device, head_dim)] = got
    return cfg


def _device_plan(pass_: str, dims: tuple[int, ...], wg: int, slots: int, causal: bool,
                 window: Optional[int], q_offset: int, persistent: bool,
                 device: torch.device) -> tuple[torch.Tensor, int]:
    """:func:`bwd_plan` as one int32 tensor on ``device`` (offsets, then
    items) and its block count, built once per shape."""
    key = (pass_, dims, wg, slots, causal, window, q_offset, persistent, str(device))
    got = _PLANS.get(key)
    if got is None:
        _build.refuse_in_capture(f"building a wgmma K1b plan {_build.EAGER_FIRST}")
        offsets, items = bwd_plan(pass_, *dims, wg=wg, slots=slots, causal=causal,
                                  window=window, q_offset=q_offset, persistent=persistent)
        plan = torch.from_numpy(np.concatenate([offsets, items])).to(device)
        got = _PLANS[key] = (plan, len(offsets) - 1)
    return got


def sm90_bwd(lib: ctypes.CDLL, fn: ctypes._CFuncPtr, q, k, v, out, lse, dout, dq, dk, dv, *,
             causal: bool, window: Optional[int], softcap: Optional[float], scale: float,
             q_offset: int, persistent: bool = True) -> None:
    """Launches a build of the wgmma K1b on checked bf16 tensors of head dim
    64, 128 or 256, writing dq, dk, dv."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    cfg = sm90_config(lib, index, D)
    n_sm = _build.sm_count(index)
    plans = [_device_plan(p, (B, Sq, Sk, Hq, Hkv), cfg[f"item_tiles_{p}"],
                          n_sm * cfg[f"blocks_per_sm_{p}"], causal, window, q_offset, persistent,
                          q.device) for p in ("dq", "dkdv")]
    stat = torch.empty((B, Hq, -(-Sq // BWD_TILE), 2 * BWD_TILE), dtype=torch.float32,
                       device=q.device)  # per 64-row q tile: lse * log2 e, delta
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stat.data_ptr(),
             plans[0][0].data_ptr(), plans[0][1], plans[1][0].data_ptr(), plans[1][1],
             B, Sq, Sk, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
             float(softcap or 0.0), float(scale), int(q_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd")


def _legacy_bwd(q, k, v, out, lse, dout, dq, dk, dv, *, causal: bool, window: Optional[int],
                softcap: Optional[float], scale: float, q_offset: int) -> None:
    """``csrc/flash_attention_bwd.cu``'s C entry on checked tensors: the
    CUDA-core and mma.sync pairs, and at bf16 D 128 / 256 the previous
    wide pair."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _bwd_entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             _build.DTYPE_CODES[q.dtype], B, Sq, Sk, Hq, Hkv, D, int(causal),
             -1 if window is None else int(window), float(softcap or 0.0), float(scale),
             int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd")


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
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    instances = bwd_instances(q.dtype, q.shape[-1])  # raises where there is none
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    _check("flash_attention_bwd", q, k, v, window, out=out, dout=dout)
    B, Sq, Hq, _ = q.shape
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 ({B}, {Hq}, {Sq}), "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if instances[0] in ("flash_bwd_dq_wgmma", "flash_bwd_dq_sm90"):
        sm90_bwd(*_sm90_entry(), q, k, v, out, lse, dout, dq, dk, dv, **kw)
    else:
        _legacy_bwd(q, k, v, out, lse, dout, dq, dk, dv, **kw)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def previous_wide_bwd(
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
    """The previous bf16 D 128 / 256 K1b (``flash_bwd_dq_wide`` +
    ``flash_bwd_dkdv_wide``, mma.sync) on CUDA tensors as
    :func:`flash_attention_bwd` takes them: ``chip_smoke.py`` and
    ``tools/k1b_variants.py`` time it beside the kernel.  The port never
    calls it, and it counts no launch."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or q.shape[-1] not in \
            BWD_WIDE_HEAD_DIMS:
        raise ValueError(f"previous_wide_bwd: bf16 CUDA tensors of head dim "
                         f"{BWD_WIDE_HEAD_DIMS} only, got {q.dtype} D {q.shape[-1]} on {q.device}")
    _check("previous_wide_bwd", q, k, v, window, out=out, dout=dout)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _legacy_bwd(q, k, v, out, lse, dout, dq, dk, dv, causal=causal, window=window,
                softcap=softcap, scale=scale, q_offset=q_offset)
    return dq, dk, dv
