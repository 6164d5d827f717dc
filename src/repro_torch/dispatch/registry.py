"""Backend registry: the dispatchable implementation tiers of the port.

Counterpart of ``repro/dispatch/registry.py``.  Every op of
:mod:`repro_torch.kernels.ops` exists in two implementations, selected by
its ``impl``: the hand-written Hopper kernel (``"kernel"``, the counterpart
of the ``pallas`` target) and the plain PyTorch version of
``kernels/ref.py`` (``"plain"``, which stands in for both the JAX
package's ``chunked`` and ``ref`` tiers: the port has no third one).  This
module names those tiers as *dispatch targets* and attaches a static cost
model to each, priced against the H100 of ``hw/specs.py``.

The static model per target is four factors on top of the card's roofline
terms (``dispatch/cost.py``):

    ``kernel_efficiency``   per port kernel (the names of
                            ``kernels.LAUNCHES``), the fraction of its
                            roofline bound the tier reaches on that
                            kernel's work: the kernel itself, or the plain
                            version that stands in for it
    ``flop_efficiency``     fraction of the peak a tier sustains on work
                            bound by a component of the card (``TC``,
                            ``CUDA``, ``HBM``, ``NVLINK``, ``HOST``;
                            ``core/sdfg.py``): a region's work, or a
                            kernel's the table above lacks
    ``byte_amplification``  multiplier on that work's HBM traffic (the
                            plain versions materialise intermediates the
                            kernels keep in registers and shared memory)
    ``launch_overhead_s``   fixed cost of each kernel call (of a region)

A run's aten ops are the same in both tiers, so they are priced at their
bound whatever the target (``cost.estimate_run``).

Every factor below cites its source: a time of ``PERF.md`` §6 (taken on an
H100 80GB HBM3 at 700 W by ``chip_smoke.py``), or it is marked as a
modelling constant.  None comes from the JAX package's TPU factors.

Availability depends on the device a caller runs on, not on the process:
the kernel tier needs CUDA tensors (``ops._resolve`` raises for any other),
so :func:`host_registry` holds it for a CUDA device only, and a CPU engine
on a machine with a card never gets a target whose variant raises.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

import torch

from repro_torch.core.sdfg import CUDA_CORE, HBM, HOST, NVLINK, TENSOR_CORE
from repro_torch.hw.specs import ChipSpec, default_chip


@dataclasses.dataclass(frozen=True)
class BackendTarget:
    """One dispatchable implementation tier with its static cost factors."""

    name: str  # registry key, e.g. "kernel"
    impl: str  # the kernels.ops impl this target runs under
    description: str = ""
    flop_efficiency: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {TENSOR_CORE: 0.5, CUDA_CORE: 0.5, HBM: 0.5}
    )
    byte_amplification: float = 1.0
    launch_overhead_s: float = 5e-6
    kernel_efficiency: Mapping[str, float] = dataclasses.field(default_factory=dict)
    requires_cuda: bool = False  # the kernel tier launches on CUDA tensors only

    def efficiency(self, component: str) -> float:
        """Sustained fraction of the peak for work bound by ``component``."""
        return float(self.flop_efficiency.get(component, 1.0))

    def available(self, device: str | torch.device = "cuda") -> bool:
        """Whether this tier runs on tensors of ``device``."""
        return not self.requires_cuda or torch.device(device).type == "cuda"


class BackendRegistry:
    """Named set of dispatch targets bound to one chip model."""

    def __init__(self, chip: Optional[ChipSpec] = None) -> None:
        self.chip = chip or default_chip()
        self._targets: dict[str, BackendTarget] = {}

    def register(self, target: BackendTarget) -> BackendTarget:
        if target.name in self._targets:
            raise ValueError(f"backend {target.name!r} already registered")
        self._targets[target.name] = target
        return target

    def get(self, name: str) -> BackendTarget:
        try:
            return self._targets[name]
        except KeyError:
            raise KeyError(
                f"unknown backend {name!r}; registered: {sorted(self._targets)}"
            ) from None

    def names(self) -> list[str]:
        return list(self._targets)

    def targets(self, names: Optional[Iterable[str]] = None) -> list[BackendTarget]:
        if names is None:
            return list(self._targets.values())
        return [self.get(n) for n in names]

    def available(self, device: str | torch.device = "cuda") -> list[BackendTarget]:
        """Targets whose variants run on tensors of ``device``."""
        return [t for t in self._targets.values() if t.available(device)]

    def __contains__(self, name: str) -> bool:
        return name in self._targets

    def __len__(self) -> int:
        return len(self._targets)


# Each kernel's efficiency comes from its row of PERF.md §6 at its largest
# measured shape (bf16), where the work dwarfs the launch: bound ms over the
# kernel's ms, and over its plain version's ms.  The bound is the one
# ``kernels/ops.py`` notes (each input read once, each output written
# once; K5's by bytes, 0.1256 ms, where §6 bounds it by the SFUs).
_KERNEL_ROWS = {  # name: (shape, bound ms, kernel ms, plain ms)
    "flash_attention": ("K1 + lse, 4x2048x15/5x64 causal", 0.0326, 0.1893, 5.7676),
    "flash_attention_bwd": ("K1b, 4x2048x15/5x64 causal", 0.0815, 0.3317, 11.8831),
    "decode_attention": ("K2, 8x1024x16/16x128", 0.0201, 0.0464, 0.4090),
    "decode_attention_stats": ("K2's stats mode, 8x1024x16/16x128", 0.0201, 0.0460, 0.3994),
    "rmsnorm": ("K3, (8192, 960)", 0.00939, 0.0172, 0.1447),
    "rmsnorm_bwd": ("K3b, (8192, 960)", 0.0141, 0.0276, 0.4103),
    "moe_gmm": ("K4, (16,80,8192)@(16,8192,24576)", 1.9482, 2.3070, 25.3464),
    "mamba_scan": ("K5, (8, 512, 16384, 16)", 0.1256, 0.3581, 218.6630),
    "rwkv6_scan": ("K6, (8, 128, 64, 64)", 0.0200, 0.0881, 11.5384),
}


def default_registry(chip: Optional[ChipSpec] = None) -> BackendRegistry:
    """The two tiers every op of ``kernels/ops.py`` has.

    * ``kernel`` — the Hopper kernels.  Each kernel's efficiency is
      ``_KERNEL_ROWS``' bound over kernel ms (0.17 for K1 to 0.84 for K4).
      Each call costs K3's launch floor, an empty kernel launched eagerly
      through the same route: 0.0050 ms (0.0008 a launch inside a CUDA
      graph).  For region pricing: tensor-core work at 0.25 of the bf16
      peak (K1b's row), other FLOPs at 0.045 of the f32 peak (K1 in f32 on
      the CUDA cores, bound 0.00703 ms against 0.1552), HBM traffic at 0.74
      of 3.35 TB/s (K4 at (64,64,2048)@(64,2048,1408), bound 0.1186 ms
      against 0.1593), bytes not amplified (each kernel reads its inputs
      once and writes its outputs once: a modelling constant).
    * ``plain`` — ``kernels/ref.py``: the same ops as chains of aten ops
      that materialise their intermediates.  Each kernel's efficiency is
      ``_KERNEL_ROWS``' bound over plain ms (0.0006 for K5 to 0.077 for
      K4).  Each call costs K3's plain version at (8, 896), whose bytes are
      nothing: 0.0292 ms.  For region pricing: bytes x 7.34 (K4's plain
      version against its kernel at the same shape, 1.1698 / 0.1593 ms,
      both byte-bound; HBM efficiency as the kernel's, the same memory),
      tensor-core work at 0.0057 of the peak (K1's plain forward in K1's
      row), other FLOPs at 0.058 of the f32 peak (K1's plain version in
      f32, bound 0.00703 ms against 0.1212: faster than the CUDA-core
      kernel there, which only the per-kernel table overrides).

    NVLink and the host link run at their data-sheet rates in both tiers
    (modelling constants: one card moves nothing over NVLink, and neither
    tier changes a host copy).
    """
    reg = BackendRegistry(chip)
    reg.register(
        BackendTarget(
            name="kernel",
            impl="kernel",
            description="hand-written Hopper kernels (CUDA C++ for sm_90a; CUDA tensors only)",
            flop_efficiency={TENSOR_CORE: 0.25, CUDA_CORE: 0.045, HBM: 0.74, NVLINK: 1.0,
                             HOST: 1.0},
            byte_amplification=1.0,
            launch_overhead_s=5.0e-6,
            kernel_efficiency={k: bound / ms for k, (_, bound, ms, _) in _KERNEL_ROWS.items()},
            requires_cuda=True,
        )
    )
    reg.register(
        BackendTarget(
            name="plain",
            impl="plain",
            description="plain PyTorch versions (kernels/ref.py; any device)",
            flop_efficiency={TENSOR_CORE: 0.0057, CUDA_CORE: 0.058, HBM: 0.74, NVLINK: 1.0,
                             HOST: 1.0},
            byte_amplification=7.34,
            launch_overhead_s=2.92e-5,
            kernel_efficiency={k: bound / ms for k, (_, bound, _, ms) in _KERNEL_ROWS.items()},
        )
    )
    return reg


def host_registry(chip: Optional[ChipSpec] = None,
                  device: str | torch.device = "cuda") -> BackendRegistry:
    """The targets whose variants run on tensors of ``device``: {kernel,
    plain} for a CUDA device, {plain} for any other.  The serving engine and
    the drivers build their variants from it, so the dispatcher never
    routes a call to a tier that cannot run there."""
    full = default_registry(chip)
    reg = BackendRegistry(full.chip)
    for t in full.available(device):
        reg.register(t)
    return reg
