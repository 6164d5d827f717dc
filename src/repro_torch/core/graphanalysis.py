"""Per-device costs of one step on a mesh, and the kernels of a captured
CUDA graph: the port's counterpart of ``repro/core/hloanalysis.py``.

The JAX package prices a step by walking the optimized per-device HLO that
XLA's SPMD partitioner wrote, multiplying loop bodies by their trip counts
and pricing every collective with the ring formulas.  The port has no HLO:
it runs the step once, eagerly, on ``DTensor``s over a ``DeviceMesh``
(``distributed/sharding.py``), and prices what one rank ran.

**(a) :func:`analyze_sharded_step`** runs ``fn(*args)`` under three dispatch
modes, outermost first:

* ``FlopCounterMode``: torch's own counter.  It sees each DTensor op once,
  at the *global* shapes, so its count over the device count is what the
  JAX record calls ``xla_cost_flops_per_dev`` (a figure for comparison,
  not the priced one);
* :class:`_ReplicateFallback`: an op that DTensor has no sharding strategy
  for (or whose strategy cannot be expressed, such as an uneven unflatten)
  is run again with every DTensor operand redistributed to ``Replicate()``
  (``distributed.constrain.replicated``).  The all-gathers that costs are
  priced like any other collective, and every such point is counted by
  (op, named scope) in ``replicated``: the mesh is never dropped silently;
* :class:`_LocalCostMode`, built on ``core/sdfg.py``'s recorder: it returns
  ``NotImplemented`` whenever a ``DTensor`` is among the types, so DTensor
  unwraps the op and the mode sees the rank's *local* ops at their local
  shapes, and every ``_c10d_functional`` collective that DTensor's
  redistribution issues, at its local size and group size.  The ops that
  DTensor's sharding propagation runs on ``FakeTensor`` stand-ins (global
  shapes, to derive output metadata) are skipped: pricing them would count
  a product twice.

FLOPs and bytes per op are the SDFG's (products by
``torch.utils.flop_counter``, one FLOP an element elsewhere, each input read
once and each output written once: an unfused upper bound, as the JAX
walk's memory term is a bound).  Collectives are priced by :data:`RING`,
the table of ``hloanalysis.py``'s ring formulas.  An eager run executes
every layer and every loop iteration, so there are no trip counts to
multiply.

**(b) :func:`captured_kernels`** is ``cost_analysis``'s counterpart for a
captured graph: the kernels of one replay of a ``serving/compiled.py`` or
``training/compiled.py`` step, by the names ``torch.profiler`` gives and
with counts, set beside the port's kernel nodes of the eager call's SDFG.
"""
from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.core import scopes, sdfg

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# Bytes one device sends for a collective whose result holds ``b`` bytes on
# it, over a group of ``n`` (ring algorithms; repro/core/hloanalysis.py).
RING: dict[str, Callable[[float, int], float]] = {
    "all-gather": lambda b, n: b * (n - 1) / n,
    "reduce-scatter": lambda b, n: b * (n - 1),
    "all-reduce": lambda b, n: 2 * b * (n - 1) / n,
    "all-to-all": lambda b, n: b * (n - 1) / n,
    "collective-permute": lambda b, n: b,
}

# torch's functional collectives (what DTensor's redistribution issues) by
# the HLO op they price as
C10D_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
_FREE = {"wait_tensor"}


def collective_bytes(op: str, result_bytes: float, n: int) -> float:
    """Ring-priced bytes of one collective (a group of one moves nothing)."""
    if n <= 1:
        return 0.0
    return RING[op](float(result_bytes), n)


def _group_size(func: Any, args: tuple) -> int:
    for a in args:  # all_gather / reduce_scatter carry it
        if isinstance(a, int) and not isinstance(a, bool) and a > 0:
            return a
    name = args[-1]
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


_CLASSES: list = []


def _classes() -> tuple[type, type]:
    """(DTensor, FakeTensor), imported once (the modes ask at every op)."""
    if not _CLASSES:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        _CLASSES.extend((DTensor, FakeTensor))
    return _CLASSES[0], _CLASSES[1]


def _has_dtensor(types) -> bool:
    dtensor = _classes()[0]
    return any(issubclass(t, dtensor) for t in types)


class _Costs(sdfg.Recorder):
    """The SDFG recorder plus the collectives, priced per op."""

    def __init__(self) -> None:
        super().__init__()
        self.coll_by_op: dict[str, float] = defaultdict(float)
        self.coll_count: Counter = Counter()

    def collective(self, func: Any, args: tuple, out: Any) -> None:
        prim = func.overloadpacket.__name__
        op = C10D_OPS[prim]
        outs = sdfg._tensors(out)
        result = float(sum(sdfg._tensor_bytes(t) for t in outs))
        n = _group_size(func, args)
        self.coll_by_op[op] += collective_bytes(op, result, n)
        self.coll_count[op] += 1
        ins = sdfg._tensors(args)
        nbytes = result + float(sum(sdfg._tensor_bytes(t) for t in ins))
        self._add(sdfg.Node(len(self.nodes), prim, sdfg.NVLINK, 0.0, nbytes,
                            scopes.current() or "<toplevel>"), ins, outs)


class _LocalCostMode(TorchDispatchMode):
    def __init__(self, costs: _Costs) -> None:
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented  # DTensor unwraps it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        prim = func.overloadpacket.__name__
        if prim in _FREE:
            return out
        ins, outs = sdfg._tensors((args, kwargs)), sdfg._tensors(out)
        fake = _classes()[1]
        if any(isinstance(t, fake) for t in ins) or any(isinstance(t, fake) for t in outs):
            return out  # DTensor's sharding propagation on stand-ins
        if prim in C10D_OPS:
            self.costs.collective(func, args, out)
        else:
            self.costs.op(func, args, kwargs, out, ins, outs)
        return out


class _ReplicateFallback(TorchDispatchMode):
    """Runs a DTensor op that DTensor cannot shard on replicated operands."""

    def __init__(self) -> None:
        super().__init__()
        self.points: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _has_dtensor(types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception as e:  # no strategy: what torch raises differs by version
            from repro_torch.distributed.constrain import replicated

            dtensor = _classes()[0]
            rep = lambda x: replicated(x) if isinstance(x, dtensor) else x  # noqa: E731
            try:
                out = func(*tree_map(rep, args), **tree_map(rep, kwargs))
            except Exception:
                raise e from None
            self.points[(func.overloadpacket.__name__, scopes.current() or "<toplevel>")] += 1
            return out


def analyze_sharded_step(fn: Callable[..., Any], *args: Any, n_devices: int,
                         **kwargs: Any) -> dict:
    """Per-device costs of one call of ``fn`` on DTensor operands.

    Returns ``analyze_hlo_text``'s record, ``flops``, ``mem_bytes``,
    ``coll_bytes`` and ``coll_by_op`` (ring bytes by HLO op name), and
    beside it ``tensor_core_flops`` (the low-precision products),
    ``coll_count`` (collectives by op), ``nodes``, ``replicated`` ({"op @
    scope": times} of the fallback) and ``flop_counter_flops_per_dev``
    (``FlopCounterMode``'s global count / ``n_devices``)."""
    from torch.utils.flop_counter import FlopCounterMode

    costs, fallback = _Costs(), _ReplicateFallback()
    counter = FlopCounterMode(display=False)
    prev = sdfg.ACTIVE
    sdfg.ACTIVE = costs  # a kernel launch notes itself (none on the meta device)
    try:
        with _LocalCostMode(costs), fallback, counter:
            fn(*args, **kwargs)
    finally:
        sdfg.ACTIVE = prev
    graph = sdfg.SDFG(costs.nodes, costs.edges)
    summary = graph.summary()
    coll = dict(costs.coll_by_op)
    return {
        "flops": sum(n.flops for n in costs.nodes),
        "mem_bytes": sum(n.bytes for n in costs.nodes),
        "coll_bytes": sum(coll.values()),
        "coll_by_op": coll,
        "tensor_core_flops": summary[sdfg.TENSOR_CORE]["flops"],
        "coll_count": dict(costs.coll_count),
        "nodes": len(costs.nodes),
        "replicated": {f"{op} @ {where}": n for (op, where), n in sorted(fallback.points.items())},
        "flop_counter_flops_per_dev": counter.get_total_flops() / n_devices,
        "sdfg": graph,
    }


# ---------------------------------------------------------------------------
# (b) the kernels of a captured graph
# ---------------------------------------------------------------------------

# The port's kernels by the names of the CUDA kernels a launch runs
# (csrc/*.cu); a launch of K2 or K1b runs two of them, and counts once,
# by the first.
KERNEL_NAMES: dict[str, tuple[str, ...]] = {
    "flash_attention": ("flash_fwd_mma", "flash_fwd_simt"),
    "flash_attention_bwd": ("flash_bwd_dq_wgmma", "flash_bwd_dq_wide", "flash_bwd_dq_mma",
                            "flash_bwd_dq"),
    "decode_attention": ("decode_split_mma", "decode_split_kernel"),
    "rmsnorm": ("rmsnorm_rows",),
    "rmsnorm_bwd": ("rmsnorm_bwd_fused",),
    "moe_gmm": ("gmm_mma", "gmm_bf16_kernel", "gmm_f32_kernel"),
    "moe_gmm_bwd": ("gmm_dgrad_gated", "gmm_dgrad", "gmm_wgrad"),
    "rwkv6_scan": ("rwkv6_scan_tiled",),
    "mamba_scan": ("mamba_scan_ring",),
}


def port_kernel(profiler_name: str) -> Optional[str]:
    """The port kernel a profiler kernel row belongs to, if any (the first
    kernel of its launch only)."""
    for port, names in KERNEL_NAMES.items():
        for n in names:
            if re.search(rf"\b{n}\b(?!_)", profiler_name):
                return port
    return None


def kernel_nodes(graph: sdfg.SDFG) -> dict[str, int]:
    """Launches of each port kernel among ``graph``'s nodes (the SDFG of an
    eager call on the card; the stats mode of K2 counts as K2)."""
    out: Counter = Counter()
    for n in graph.nodes:
        if n.kernel:
            out["decode_attention" if n.primitive == "decode_attention_stats"
                else n.primitive] += 1
    return dict(out)


def captured_kernels(step: Any, eager: Optional[sdfg.SDFG] = None, replays: int = 3) -> dict:
    """The kernels of one replay of ``step`` (a ``CompiledStep`` that has
    captured its graph), by profiler name with counts (``kernels``), the
    port's among them by kernel (``port_kernels``), and with ``eager`` (the
    SDFG of the eager call of the same step) its kernel nodes beside them
    (``sdfg_kernels``, ``equal``).

    A profiler session can lose the device activity it records first, so
    the graph replays ``replays`` times in one ``torch.profiler`` session,
    each after a sync and a pause, and the inventory is the last replay's:
    the session's kernels split at the pauses (``replays_seen`` says how
    many groups the session held)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    graph = getattr(step, "_graph", None)
    if graph is None:
        raise ValueError("captured_kernels: the step has not captured a graph yet")
    pause_s = 0.02
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            time.sleep(pause_s)
            graph.replay()
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.key) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("Memcpy", "Memset")))
    groups: list[list[str]] = []
    last = None
    for t, name in kernels:  # a replay's kernels follow each other within microseconds
        if last is None or t - last > 0.5 * pause_s * 1e6:
            groups.append([])
        groups[-1].append(name)
        last = t
    rows = Counter(groups[-1] if groups else [])
    port: Counter = Counter()
    for name, n in rows.items():
        k = port_kernel(name)
        if k is not None:
            port[k] += n
    out = {"kernels": sorted(rows.items(), key=lambda kv: -kv[1]), "port_kernels": dict(port),
           "n_kernels": sum(rows.values()), "replays_seen": len(groups)}
    if eager is not None:
        nodes = kernel_nodes(eager)
        out["sdfg_kernels"] = nodes
        out["equal"] = nodes == dict(port)
    return out
