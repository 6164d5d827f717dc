"""Hardware backend models: the counterpart of ``repro/hw/specs.py``.

Every SDFG node (``core/sdfg.py``) is assigned to one component of the
card (tensor cores, CUDA cores, HBM, NVLink, the host link), and the
roofline (``core/roofline.py``) prices a node's work against that
component's rate.  The numbers below are the NVIDIA H100 SXM5 data sheet's
(dense, no sparsity; TF32 is off in the port, so f32 runs on the CUDA
cores): modelling constants, never measured.  ``chip_smoke.py`` prints
what the card itself reports (memory, SM count, clock) beside them.

Where the TPU model has VMEM (the scratchpad a Pallas kernel tiles
through), the H100 has each SM's shared memory; where it has ICI links,
NVLink; the host link is PCIe Gen5 x16.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card hardware constants for one accelerator generation."""

    name: str
    # Compute units (FLOP/s): tensor cores (bf16) and CUDA cores (f32).
    peak_flops_bf16: float
    peak_flops_f32: float
    # Memory hierarchy: HBM -> shared memory (per SM) -> registers.
    hbm_bytes: int
    hbm_bw: float  # bytes/s
    smem_bytes: int  # shared memory an SM (the VMEM counterpart)
    sm_count: int
    # Interconnect: NVLink (the ICI counterpart).
    link_bw: float  # bytes/s per link, one direction
    links: int
    # Host link (PCIe): the "system" side of the sys/user split.
    host_bw: float  # bytes/s, one direction
    # Launch limits a kernel's plan must meet (the tuner's feasibility,
    # ``tune/space.py``; the kernels' plans in ``kernels/plan.py``).
    smem_block_bytes: int  # dynamic shared memory one block may opt into
    threads_per_block: int
    regs_per_sm: int  # 32-bit registers of one SM's register file

    @property
    def link_total_bw(self) -> float:
        return self.link_bw * self.links

    @property
    def machine_balance(self) -> float:
        """FLOP a byte of HBM traffic at which the tensor cores and HBM take
        equal time (989e12 / 3.35e12 = 295 on the H100 SXM)."""
        return self.peak_flops_bf16 / self.hbm_bw


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,  # data sheet: bf16 tensor cores, dense
    peak_flops_f32=67e12,  # data sheet: f32 on the CUDA cores
    hbm_bytes=80 * 10**9,  # data sheet: 80 GB HBM3
    hbm_bw=3.35e12,  # data sheet: 3.35 TB/s
    smem_bytes=228 * 1024,  # data sheet: 228 KB shared memory an SM
    sm_count=132,  # data sheet: 132 SMs (SXM5)
    link_bw=25e9,  # data sheet: NVLink 4, 18 links of 50 GB/s both ways
    links=18,
    host_bw=64e9,  # data sheet: PCIe Gen5 x16, 128 GB/s both ways
    smem_block_bytes=227 * 1024,  # CUDA guide, compute capability 9.0: 227 KB a block
    threads_per_block=1024,  # CUDA guide: 1024 threads a block
    regs_per_sm=65536,  # CUDA guide, compute capability 9.0: 64 K registers an SM
)


def default_chip() -> ChipSpec:
    return H100_SXM
