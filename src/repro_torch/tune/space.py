"""Design spaces: the candidate config grid per (kernel op, dispatch tier).

Counterpart of ``repro/tune/space.py`` with a Hopper space in place of the
TPU one (ROADMAP R3).  A :class:`KernelSpace` names the runtime knobs of
one entry point on one tier of ``kernels/ops.py`` (``kernel``: the Hopper
kernel's launch plan; ``plain``: the plain version's chunk), the value
each ships with, and a fixed *sweep workload*, the served bf16 shape the
tuner measures on.  Enumeration is constraint-aware:

* **alignment** and **divisibility**, as in the JAX package: a chunk must
  be a multiple of 8 and tile the workload dim it walks (the chunked scans
  need ``T % chunk == 0``);
* **launch limits** of the card (``hw/specs.py``): the point's plan, from
  the same functions the wrappers launch with (``kernels/plan.py``), must
  fit one block's dynamic shared memory (227 KB) and threads (1024);
* **registers**, where ptxas' report of the built instance is known (on
  the card, ``kernels/moe_gmm.ptxas_report``): an instance that spills is
  infeasible, and one whose registers times its threads pass an SM's
  65536 too.

Each space also prices a point a priori (:meth:`KernelSpace.roofline_s`),
the JAX package's formula: FLOPs over a tier's share of the card's peak
for the workload's type, bytes over its share of the memory rate, and a
per-launch cost, with the H100's numbers; the
:class:`~repro_torch.tune.prune.RooflinePruner` cuts against it and the
``synthetic`` sweep returns it, jittered, as a pseudo-measurement.

K1 has no space: its tile knobs are compile-time
(``csrc/flash_attention.cu``), and its plain tier has no KV-block loop, so
JAX's ``flash_attention/chunked`` space has no counterpart
(:data:`NOT_SWEPT`).  K3 has none in the JAX package either, and K5's
kernel knobs are all compile-time (``csrc/mamba_scan.cu``): only its plain
tier's chunk is swept.

This module imports no ``torch``: the fleet daemon, CPU jobs and
``synthetic`` sweep workers enumerate and price spaces without it.  Real
measurement lives in :mod:`repro_torch.tune.explore`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
from typing import Any, Callable, Mapping, Optional

from repro_torch.dispatch.profiles import encode_config
from repro_torch.hw.specs import ChipSpec, default_chip
from repro_torch.kernels import plan

# (flop share of the peak, share of the memory rate, seconds a launch) per
# (tier, peak), from dispatch/registry.py's factors (PERF.md §6's times on
# an H100 80GB HBM3 at 700 W): the kernel tier's tensor-core work at 0.25
# of the bf16 peak (K1b), CUDA-core work at 0.045 of the f32 peak (K1 in
# f32), HBM at 0.74 (K4), K3's 5 us launch floor; the plain tier's tensor-
# core work at 0.0057, f32 at 0.058, bytes amplified 7.34x (K4's plain
# version against its kernel), 29.2 us a call (K3's plain version).
_TIER = {
    ("kernel", "peak_flops_bf16"): (0.25, 0.74, 5.0e-6),
    ("kernel", "peak_flops_f32"): (0.045, 0.74, 5.0e-6),
    ("plain", "peak_flops_bf16"): (0.0057, 0.74 / 7.34, 2.92e-5),
    ("plain", "peak_flops_f32"): (0.058, 0.74 / 7.34, 2.92e-5),
}

F32 = 4  # bytes of the scan spaces' cost model, as in the JAX package
BF16 = 2

# what the JAX package sweeps and the port does not, and why
NOT_SWEPT = {
    "flash_attention/kernel": "tile knobs are compile-time (csrc/flash_attention.cu); the "
                              "space follows ROADMAP P3's redesign",
    "flash_attention/chunked": "no counterpart: the port's plain tier has no KV-block loop",
    "mamba_scan/kernel": "every knob is compile-time (csrc/mamba_scan.cu); ROADMAP P7",
}


def _sig(*arrays: tuple[str, tuple[int, ...]]) -> str:
    """Analytic ``dispatch.profiles.signature`` of a workload, computed
    without materialising tensors (or importing torch)."""
    return ";".join(
        f"{dtype}[{','.join(map(str, shape))}]" for dtype, shape in arrays
    )


@dataclasses.dataclass(frozen=True)
class ConfigPoint:
    """One candidate configuration of one (op, tier)."""

    op: str
    backend: str
    params: Mapping[str, Any]

    @property
    def config(self) -> str:
        return encode_config(self.params)


@dataclasses.dataclass(frozen=True)
class Launch:
    """What one point's plan asks of the card: a block's dynamic shared
    memory and threads, and the kernel instance it launches (ptxas' key)."""

    smem_bytes: int
    threads: int
    instance: str


@dataclasses.dataclass(frozen=True)
class KernelSpace:
    """The tunable design space of one kernel entry point on one tier.

    ``grid`` maps each knob to its candidate values; ``defaults`` is the
    shipped config (always enumerated, never pruned: the tuner must beat it
    on equal terms).  ``divides`` maps a knob to the workload dim it must
    tile exactly.  ``cost`` returns ``(flops, bytes, launches)`` for a
    param dict and the workload; ``launch`` the point's :class:`Launch`
    (None: the plain tier, no launch limits of its own), or raises
    ``ValueError`` for a value its plan refuses.  ``inputs`` are the
    workload's tensors, ``(dtype, shape)`` each, in the entry point's
    argument order (``sig`` is theirs).  ``peak`` names the ChipSpec peak
    its FLOPs run at; ``tier`` overrides ``_TIER``'s factors.  ``cost``
    and ``launch`` are module-level functions (or partials of them), so a
    space pickles into a sweep worker.
    """

    op: str
    backend: str
    impl: str
    grid: Mapping[str, tuple[int, ...]]
    defaults: Mapping[str, int]
    align: Mapping[str, int]
    divides: Mapping[str, str]
    workload: Mapping[str, int]
    sig: str
    cost: Callable[[Mapping[str, int], Mapping[str, int], ChipSpec],
                   tuple[float, float, float]]
    launch: Optional[Callable[[Mapping[str, int], Mapping[str, int], ChipSpec], Launch]] = None
    inputs: tuple[tuple[str, tuple[int, ...]], ...] = ()
    peak: str = "peak_flops_f32"
    tier: Optional[tuple[float, float, float]] = None

    @property
    def key(self) -> str:
        return f"{self.op}/{self.backend}"

    @property
    def default_config(self) -> str:
        return encode_config(self.defaults)

    def plan(self, params: Mapping[str, int],
             chip: Optional[ChipSpec] = None) -> Optional[Launch]:
        """The point's launch on ``chip`` (None on the plain tier)."""
        if self.launch is None:
            return None
        return self.launch(params, self.workload, chip or default_chip())

    def feasible(self, params: Mapping[str, int], chip: Optional[ChipSpec] = None,
                 ptxas: Optional[Mapping[str, Mapping[str, int]]] = None) -> bool:
        """Alignment, divisibility, the plan's shared memory and threads a
        block, and, for an instance in ``ptxas`` (``{instance: {"registers",
        "spill_bytes"}}``), no spill and registers x threads within an SM's
        register file."""
        chip = chip or default_chip()
        for name, value in params.items():
            if value % self.align.get(name, 1) != 0:
                return False
            dim = self.divides.get(name)
            if dim is not None and self.workload[dim] % min(value, self.workload[dim]) != 0:
                return False
            if value <= 0:
                return False
        try:
            launch = self.plan(params, chip)
        except ValueError:
            return False
        if launch is None:
            return True
        if launch.smem_bytes > chip.smem_block_bytes or launch.threads > chip.threads_per_block:
            return False
        rep = (ptxas or {}).get(launch.instance)
        if rep is not None and (rep["spill_bytes"] > 0
                                or rep["registers"] * launch.threads > chip.regs_per_sm):
            return False
        return True

    def points(self, chip: Optional[ChipSpec] = None,
               ptxas: Optional[Mapping[str, Mapping[str, int]]] = None) -> list[ConfigPoint]:
        """Feasible candidate points, defaults included, deterministic order."""
        chip = chip or default_chip()
        names = sorted(self.grid)
        seen: list[ConfigPoint] = []
        for values in itertools.product(*(self.grid[n] for n in names)):
            params = dict(zip(names, values))
            if self.feasible(params, chip, ptxas):
                seen.append(ConfigPoint(self.op, self.backend, params))
        if not any(p.params == dict(self.defaults) for p in seen):
            # the shipped defaults are known-good: enumerate them even if the
            # grid was narrowed past them
            seen.append(ConfigPoint(self.op, self.backend, dict(self.defaults)))
        return seen

    def roofline_s(self, params: Mapping[str, int],
                   chip: Optional[ChipSpec] = None) -> float:
        """A-priori cost of one point: roofline terms + launch overhead."""
        chip = chip or default_chip()
        flop_eff, hbm_eff, launch_s = self.tier or _TIER[(self.backend, self.peak)]
        flops, hbm_bytes, launches = self.cost(params, self.workload, chip)
        return (
            flops / (flop_eff * getattr(chip, self.peak))
            + hbm_bytes / (hbm_eff * chip.hbm_bw)
            + launches * launch_s
        )

    def synthetic_s(self, params: Mapping[str, int],
                    chip: Optional[ChipSpec] = None) -> float:
        """Deterministic pseudo-measurement for ``--tune-mode synthetic``.

        The roofline prediction perturbed by a stable per-config hash (+0 to
        5 %), so sweeps are reproducible across processes and worker counts
        while still exercising the measured-beats-predicted argmin path.
        """
        digest = hashlib.sha1(
            f"{self.op}|{self.backend}|{encode_config(params)}".encode()
        ).digest()
        jitter = 1.0 + 0.05 * (digest[0] / 255.0)
        return self.roofline_s(params, chip) * jitter


# ---------------------------------------------------------------------------
# Per-kernel space definitions
# ---------------------------------------------------------------------------


def _decode_cost(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec):
    """Both products over every slot; the caches, q / o and positions read
    or written once, and the split's f32 partials written and read back."""
    B, S, Hq, Hkv, D = w["B"], w["S"], w["Hq"], w["Hkv"], w["D"]
    n_split, _ = plan.split_plan(B, Hkv, S, chip.sm_count, p["waves"])
    flops = 4.0 * B * Hq * S * D
    hbm = (BF16 * (2 * B * S * Hkv * D + 2 * B * Hq * D) + 4 * B * (S + 1)
           + 2 * 4 * B * Hq * n_split * (D + 2))
    return flops, hbm, 2  # the split pass and the combine


def _decode_launch(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec) -> Launch:
    _, chunk = plan.split_plan(w["B"], w["Hkv"], w["S"], chip.sm_count, p["waves"])
    return Launch(plan.split_smem(w["D"], chunk, BF16, tensor_cores=True), plan.DECODE_THREADS,
                  f"decode_split_mma<{w['D']}>")


def _gmm_cost(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec):
    """Rows padded to whole row blocks are multiplied (as zeros); each row
    block reads its experts' weights once."""
    E, C, D, F = w["E"], w["C"], w["D"], w["F"]
    tp = plan.tile_plan(E, C, F, p["max_row_tiles"])
    rows = tp.row_blocks * tp.row_tiles * plan.ROW_TILE
    flops = 2.0 * E * rows * D * F
    hbm = BF16 * E * (C * D + tp.row_blocks * D * F + C * F)
    return flops, hbm, 1


def _gmm_launch(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec) -> Launch:
    tp = plan.tile_plan(w["E"], w["C"], w["F"], p["max_row_tiles"])
    return Launch(tp.smem_bytes, plan.GMM_THREADS, f"gmm_mma<{tp.row_tiles}>")


def _rwkv_kernel_cost(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec):
    """A step's kv outer product, state update and r . state on every state
    element; each column tile of a block reads r, k and w again."""
    B, T, H, K, V = w["B"], w["T"], w["H"], w["K"], w["V"]
    sp = plan.scan_plan(B, H, K, V, chip.sm_count, BF16, p["column_tile"])
    flops = 4.0 * B * T * H * K * V
    hbm = (sp.grid[0] * B * T * H * K * (2 * BF16 + F32) + 2 * BF16 * B * T * H * V
           + F32 * (H * K + 2 * B * H * K * V))
    return flops, hbm, 1


def _rwkv_launch(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec) -> Launch:
    sp = plan.scan_plan(w["B"], w["H"], w["K"], w["V"], chip.sm_count, BF16, p["column_tile"])
    return Launch(sp.smem_bytes, sp.threads, f"rwkv6_scan_tiled<{w['K']}>")


def scan_cost(p: Mapping[str, int], w: Mapping[str, int], chip: ChipSpec, state_cols: str):
    """Chunked linear-scan cost, the JAX package's: within-chunk pairwise
    work is O(T·L), the chunk loop costs one launch per T/L iterations —
    the small-chunk (loop-bound) vs large-chunk (compute/memory-bound)
    trade."""
    B, T = w["B"], w["T"]
    width = w[state_cols]
    rows = w.get("K", w.get("DI"))
    L = min(p["chunk"], T)
    flops = 4.0 * B * T * L * rows + 2.0 * B * T * rows * width
    hbm = F32 * B * T * rows * 6
    launches = -(-T // L)
    return flops, hbm, launches


def default_spaces() -> dict[str, KernelSpace]:
    """The shipped design spaces, keyed ``"op/tier"``: the served bf16
    shapes of ``PERF.md`` §6, so a winner is measured where it runs.  Each
    default is what the wrapper or ``kernels/ops.py`` uses when nothing is
    tuned."""
    dec = {"B": 8, "S": 1024, "Hq": 16, "Hkv": 16, "D": 128}  # deepseek-moe-16b's tick
    dec_in = (("bfloat16", (8, 16, 128)), ("bfloat16", (8, 1024, 16, 128)),
              ("bfloat16", (8, 1024, 16, 128)), ("int32", (8, 1024)), ("int32", (8,)))
    gmm = {"E": 16, "C": 160, "D": 6144, "F": 10752}  # dbrx-132b's prefill
    gmm_in = (("bfloat16", (16, 160, 6144)), ("bfloat16", (16, 6144, 10752)))
    rwkv = {"B": 1, "T": 512, "H": 64, "K": 64, "V": 64}  # rwkv6-7b's prefill
    rwkv_in = (("bfloat16", (1, 512, 64, 64)), ("bfloat16", (1, 512, 64, 64)),
               ("bfloat16", (1, 512, 64, 64)), ("float32", (1, 512, 64, 64)),
               ("float32", (64, 64)), ("float32", (1, 64, 64, 64)))
    mamba = {"B": 1, "T": 512, "DI": 16384, "N": 16}  # jamba-1.5-large's prefill
    mamba_in = (("bfloat16", (1, 512, 16384)), ("bfloat16", (1, 512, 16384)),
                ("float32", (16384, 16)), ("bfloat16", (1, 512, 16)),
                ("bfloat16", (1, 512, 16)), ("float32", (16384,)),
                ("float32", (1, 16384, 16)))
    default_vb = plan.scan_plan(1, 64, 64, 64, default_chip().sm_count, BF16).vb
    spaces = [
        KernelSpace(
            op="decode_attention", backend="kernel", impl="kernel",
            grid={"waves": (1, 2, 3, 4, 6)}, defaults={"waves": plan.WAVES},
            align={}, divides={}, workload=dec, sig=_sig(*dec_in),
            cost=_decode_cost, launch=_decode_launch, inputs=dec_in,
            peak="peak_flops_bf16",
        ),
        KernelSpace(
            op="moe_gmm", backend="kernel", impl="kernel",
            grid={"max_row_tiles": (2, 4, 5, 8, 10)},
            defaults={"max_row_tiles": plan.MAX_ROW_TILES},
            align={}, divides={}, workload=gmm, sig=_sig(*gmm_in),
            cost=_gmm_cost, launch=_gmm_launch, inputs=gmm_in, peak="peak_flops_bf16",
        ),
        KernelSpace(
            op="rwkv6_scan", backend="kernel", impl="kernel",
            grid={"column_tile": (16, 32, 64)}, defaults={"column_tile": default_vb},
            align={}, divides={}, workload=rwkv, sig=_sig(*rwkv_in),
            cost=_rwkv_kernel_cost, launch=_rwkv_launch, inputs=rwkv_in,
        ),
        KernelSpace(
            op="rwkv6_scan", backend="plain", impl="plain",
            grid={"chunk": (8, 16, 32, 64, 128)}, defaults={"chunk": 32},
            align={"chunk": 8}, divides={"chunk": "T"}, workload=rwkv, sig=_sig(*rwkv_in),
            cost=functools.partial(scan_cost, state_cols="V"), inputs=rwkv_in,
        ),
        KernelSpace(
            op="mamba_scan", backend="plain", impl="plain",
            grid={"chunk": (16, 32, 64, 128, 256)}, defaults={"chunk": 128},
            align={"chunk": 8}, divides={"chunk": "T"}, workload=mamba, sig=_sig(*mamba_in),
            cost=functools.partial(scan_cost, state_cols="N"), inputs=mamba_in,
        ),
    ]
    return {s.key: s for s in spaces}


def space_report(chip: Optional[ChipSpec] = None,
                 ptxas: Optional[Mapping[str, Mapping[str, int]]] = None,
                 prune_ratio: Optional[float] = None) -> list[dict[str, Any]]:
    """Per space: its grid, default, feasible / pruned / swept point counts
    and each grid point's launch (shared memory, threads, instance) with
    its feasibility; ``spaces`` in the CLI, phase 10 (a) on the card."""
    from repro_torch.tune.prune import DEFAULT_PRUNE_RATIO, RooflinePruner

    chip = chip or default_chip()
    pruner = RooflinePruner(chip, DEFAULT_PRUNE_RATIO if prune_ratio is None else prune_ratio)
    rows = []
    for key, space in sorted(default_spaces().items()):
        points = space.points(chip, ptxas)
        kept, cut = pruner.prune(space, points)
        grid = []
        names = sorted(space.grid)
        for values in itertools.product(*(space.grid[n] for n in names)):
            params = dict(zip(names, values))
            try:
                launch = space.plan(params, chip)
            except ValueError as exc:
                launch, why = None, str(exc)
            else:
                why = None
            row: dict[str, Any] = {"config": encode_config(params),
                                   "feasible": space.feasible(params, chip, ptxas)}
            if why is None:
                row["predicted_s"] = space.roofline_s(params, chip)
            if launch is not None:
                row.update(smem_bytes=launch.smem_bytes, threads=launch.threads,
                           instance=launch.instance)
                if ptxas and launch.instance in ptxas:
                    row["ptxas"] = dict(ptxas[launch.instance])
            if why:
                row["refused"] = why
            grid.append(row)
        rows.append({
            "space": key, "grid": {k: list(v) for k, v in space.grid.items()},
            "default": space.default_config, "feasible": len(points),
            "pruned": len(cut), "sweep": len(kept), "points": grid,
        })
    return rows
