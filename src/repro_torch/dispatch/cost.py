"""A-priori cost model: price an SDFG region per backend target.

Counterpart of ``repro/dispatch/cost.py``.  The estimate is the roofline of
``core/roofline.py`` (compute against memory against the H100's peaks)
with the target's static factors from :mod:`repro_torch.dispatch.registry`
applied on top, so before anything has run every (region, backend) pair
has a seconds figure.  These estimates seed the dispatcher; measured
profiles replace them once warm (:mod:`repro_torch.dispatch.profiles`).

Where the JAX version prices every FLOP at the bf16 peak, this one prices
as the port's roofline does: tensor-core FLOPs at the bf16 peak, every
other FLOP at the f32 one, bytes at the HBM rate; NVLink bytes at the
card's total link rate (none on one card) and host-link bytes at the PCIe
rate.  A region (``estimate_region``, ``estimate_sdfg``) takes the target's
factors on all of its work; one run's record (``estimate_run``,
``estimate_callable``) takes them on its kernel launches only, the work
the tiers do differently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import sdfg as sdfg_mod
from repro_torch.core.sdfg import CUDA_CORE, HBM, HOST, NVLINK, SDFG, TENSOR_CORE, Region
from repro_torch.dispatch.registry import BackendTarget
from repro_torch.hw.specs import ChipSpec, default_chip


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Priced execution of one region (or whole graph) on one backend."""

    backend: str
    seconds: float
    t_compute: float
    t_memory: float
    t_collective: float
    t_host: float
    source: str = "roofline"  # roofline | measured

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
            "host": self.t_host,
        }
        return max(terms, key=terms.get)


def estimate_region(
    region: Region,
    target: BackendTarget,
    chip: Optional[ChipSpec] = None,
) -> CostEstimate:
    """Roofline pricing of ``region`` on ``target``:
    launch overhead + max(compute, memory) + collective + host.

    Compute: the region's tensor-core FLOPs at the bf16 peak times the
    target's ``TC`` efficiency, plus its other FLOPs at the f32 peak times
    its ``CUDA`` efficiency.  Memory: its bytes times the target's byte
    amplification at the HBM rate times its ``HBM`` efficiency.
    """
    chip = chip or default_chip()
    tc_flops = float(region.backends.get(TENSOR_CORE, 0.0))
    other_flops = max(region.flops - tc_flops, 0.0)
    t_compute = (tc_flops / (chip.peak_flops_bf16 * max(target.efficiency(TENSOR_CORE), 1e-6))
                 + other_flops / (chip.peak_flops_f32 * max(target.efficiency(CUDA_CORE), 1e-6)))
    t_memory = (region.bytes * target.byte_amplification
                / (chip.hbm_bw * max(target.efficiency(HBM), 1e-6)))
    link_bytes = float(region.backends.get(NVLINK, 0.0))
    t_collective = link_bytes / (chip.link_total_bw * max(target.efficiency(NVLINK), 1e-6))
    host_bytes = float(region.backends.get(HOST, 0.0))
    t_host = host_bytes / (chip.host_bw * max(target.efficiency(HOST), 1e-6))
    seconds = target.launch_overhead_s + max(t_compute, t_memory) + t_collective + t_host
    return CostEstimate(
        backend=target.name,
        seconds=seconds,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_collective,
        t_host=t_host,
    )


def estimate_sdfg(
    graph: SDFG,
    target: BackendTarget,
    chip: Optional[ChipSpec] = None,
) -> dict[str, CostEstimate]:
    """Per-region estimates for a whole extracted graph."""
    chip = chip or default_chip()
    return {name: estimate_region(r, target, chip) for name, r in graph.regions().items()}


def total_seconds(estimates: dict[str, CostEstimate]) -> float:
    return sum(e.seconds for e in estimates.values())


def estimate_run(
    graph: SDFG,
    target: BackendTarget,
    chip: Optional[ChipSpec] = None,
) -> CostEstimate:
    """Price one run's record (``sdfg.extract``) on ``target``, node by node.

    The aten ops are the same in either tier, so each is priced at its
    roofline bound, whatever the target: max(compute, memory), with
    tensor-core FLOPs at the bf16 peak, other FLOPs at the f32 peak and
    bytes at the HBM rate; NVLink and host-link bytes at their rates.  Each
    launch of a port kernel (a node the kernels' notes made) is what the
    tiers do differently: its bound over the target's efficiency on that
    kernel (``kernel_efficiency``; for a kernel the table lacks, its
    component's ``flop_efficiency``), plus the target's launch overhead.
    """
    chip = chip or default_chip()
    t_compute = t_memory = t_collective = t_host = seconds = 0.0
    for n in graph.nodes:
        if n.backend == NVLINK:
            t = n.bytes / (chip.link_total_bw * max(target.efficiency(NVLINK), 1e-6))
            t_collective += t
        elif n.backend == HOST:
            t = n.bytes / (chip.host_bw * max(target.efficiency(HOST), 1e-6))
            t_host += t
        else:
            tc = n.flops if n.backend == TENSOR_CORE else 0.0
            c = tc / chip.peak_flops_bf16 + (n.flops - tc) / chip.peak_flops_f32
            m = n.bytes / chip.hbm_bw
            if n.kernel:
                eff = target.kernel_efficiency.get(n.primitive, target.efficiency(n.backend))
                c, m = c / max(eff, 1e-6), m / max(eff, 1e-6)
            t_compute, t_memory = t_compute + c, t_memory + m
            t = max(c, m) + (target.launch_overhead_s if n.kernel else 0.0)
        seconds += t
    return CostEstimate(
        backend=target.name,
        seconds=seconds,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_collective,
        t_host=t_host,
    )


def estimate_callable(
    fn: Callable,
    *args: Any,
    target: BackendTarget,
    chip: Optional[ChipSpec] = None,
    **kwargs: Any,
) -> CostEstimate:
    """Price a whole callable on ``target`` (:func:`estimate_run` of its
    record).

    The record comes from one ``sdfg.extract`` run of the op's *canonical*
    form, which the caller passes: the op under ``impl="auto"``, whose
    kernels note their FLOPs and bytes on the card and whose plain aten
    ops are recorded one by one on the CPU (as the JAX version prices the
    ``chunked`` form); the target factors then tell the tiers apart over
    the same work.  Where the JAX version merges the record into one region
    and applies its factors to all of it, this one applies them to the
    kernels' work only, which is all that differs between the tiers (on
    the CPU, with no kernel launched, the tiers price alike).

    Unlike the JAX version, which only traces a jaxpr, ``sdfg.extract``
    *runs* ``fn``.  Whatever ``fn`` updates in place is updated: priced on
    the serving engine's own caches, a decode step would write its KV
    caches (the same rewrite the real step then makes) and advance the
    RWKV6 ``wkv`` / ``shift`` and Mamba ``ssm`` / ``conv`` states, which
    is wrong.  So a caller prices such a step against a scratch set of the
    same shapes (``lm.init_caches``), as the engine does, or saves and
    restores what the step updates in place.
    """
    return estimate_run(sdfg_mod.extract(fn, *args, **kwargs), target, chip)
