"""Stateful-dataflow-multigraph extraction and component assignment (Fig. 1),
the counterpart of ``repro/core/sdfg.py``.

Adaptyst represents a program as an SDFG whose nodes are each assigned to a
backend module modelling one system component.  The JAX package reads the
program from its jaxpr; the port records it from one run:
``extract(fn, *args)`` calls ``fn`` under a ``TorchDispatchMode`` and makes
a :class:`Node` of every aten op the dispatcher sees, and of every kernel
launch the port's ``kernels/ops.py`` entries note (the kernels launch
through ctypes, outside the dispatcher: each entry reports its name, its
tensors and its FLOPs to the active recorder, and with none active costs
one global check).  The components are the H100's:

    TC      tensor cores      (bf16 / f16 products: mm, bmm, K1, K1b, K2, K4)
    CUDA    CUDA cores        (f32 products, elementwise ops, reductions,
                               the norm and scan kernels K3, K3b, K5, K6)
    HBM     memory movement   (copies, casts, gathers, concatenation,
                               creation; views move nothing)
    NVLINK  interconnect      (collectives; none on one card)
    HOST    the host link     (syncs: .item(), device-to-host copies)

A node's FLOPs: ``torch.utils.flop_counter``'s formulas for products, one
an input element for reductions and one an output element elsewhere (as
the JAX package counts); a kernel's, the count its bound uses in
``PERF.md`` §6.  Its bytes: each tensor input read once and each output
written once (a broadcast input counts its distinct elements; a view, an
allocation and a kernel's output buffer allocation count none).  A kernel
whose work depends on its data counts what its shapes allow (K2: every
cache slot), since reading which slots are live would be a sync.

Nodes group into regions by their named-scope path (``core/scopes.py``),
and each region gets a roofline *match* against the H100's machine balance
(989e12 / 3.35e12 = 295 FLOP a byte).  Backward ops run on autograd's
thread, outside the forward's scopes; a remat recompute runs the forward
code again and opens its scopes there.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import scopes
from repro_torch.hw.specs import ChipSpec, default_chip

TENSOR_CORE, CUDA_CORE, HBM, NVLINK, HOST = "TC", "CUDA", "HBM", "NVLINK", "HOST"
COMPONENTS = (TENSOR_CORE, CUDA_CORE, HBM, NVLINK, HOST)

_LOW_PRECISION = (torch.bfloat16, torch.float16)
_HOST_PRIMS = {"_local_scalar_dense", "nonzero", "item"}
_FREE_PRIMS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "alias", "set_", "resize_"}
_HBM_PRIMS = {
    "embedding", "index", "index_select", "gather", "scatter", "scatter_add", "index_put",
    "index_put_", "index_add", "index_copy", "slice_scatter", "select_scatter", "cat",
    "stack", "copy", "copy_", "_to_copy", "clone", "contiguous", "constant_pad_nd", "flip",
    "roll", "repeat", "repeat_interleave", "arange", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "fill",
    "fill_", "zero_", "where", "masked_fill", "masked_fill_", "tril", "triu",
    "_unsafe_index", "embedding_dense_backward",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp",
               "cumsum", "cumprod", "sort", "topk", "norm", "linalg_vector_norm", "var",
               "std", "prod", "all", "any"}
_PRODUCT_NAMES = frozenset(getattr(p, "__name__", str(p)) for p in flop_registry)


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a stride-0 axis is one element)."""
    try:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
    except (RuntimeError, NotImplementedError):  # no strides (sparse, nested)
        n = t.numel()
    return n * t.element_size()


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Node:
    id: int
    primitive: str  # aten packet ("mm") or a port kernel's name
    backend: str  # one of COMPONENTS
    flops: float
    bytes: float
    region: str  # the named-scope path, "<toplevel>" outside every scope
    product: bool = False  # a matrix product (tensor-core or f32)
    kernel: bool = False  # a launch of one of the port's kernels
    params: dict = dataclasses.field(default_factory=dict, repr=False)


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    bytes: float


@dataclasses.dataclass
class Region:
    """A named-scope code block with aggregate roofline terms."""

    name: str
    flops: float = 0.0
    bytes: float = 0.0
    nodes: int = 0
    backends: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    def match(self, chip: Optional[ChipSpec] = None) -> str:
        """The Adaptyst 'match': which component bounds this region."""
        chip = chip or default_chip()
        if self.backends.get(HOST):
            return HOST
        if self.backends.get(NVLINK, 0.0) > 0.5 * self.bytes:
            return NVLINK
        if self.intensity() >= chip.machine_balance and self.backends.get(TENSOR_CORE):
            return TENSOR_CORE
        if self.backends.get(TENSOR_CORE, 0.0) > 0.5 * self.flops:
            # product-heavy but HBM-bound at this size
            return HBM
        return CUDA_CORE if self.flops > self.bytes else HBM


def classify(prim: str, tensors: Iterable[torch.Tensor]) -> tuple[str, bool]:
    """(component, is a product) of an aten op by its packet name and the
    tensors it touched."""
    tensors = list(tensors)
    devices = {t.device.type for t in tensors}
    if prim in _HOST_PRIMS or ("cpu" in devices and len(devices) > 1):
        return HOST, False
    if prim.startswith(("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                        "broadcast_", "send", "recv")):
        return NVLINK, False
    if prim in _PRODUCT_NAMES:
        low = bool(tensors) and tensors[0].dtype in _LOW_PRECISION
        return (TENSOR_CORE if low else CUDA_CORE), True
    if prim in _HBM_PRIMS or prim in _FREE_PRIMS:
        return HBM, False
    return CUDA_CORE, False


@dataclasses.dataclass
class SDFG:
    nodes: list[Node]
    edges: list[Edge]

    def regions(self) -> dict[str, Region]:
        regs: dict[str, Region] = {}
        for n in self.nodes:
            r = regs.setdefault(n.region, Region(n.region))
            r.flops += n.flops
            r.bytes += n.bytes
            r.nodes += 1
            r.backends[n.backend] += n.flops if n.backend == TENSOR_CORE else n.bytes
        return regs

    def summary(self) -> dict[str, dict[str, float]]:
        """Aggregate flops / bytes / node count per component."""
        out: dict[str, dict[str, float]] = {
            b: {"flops": 0.0, "bytes": 0.0, "nodes": 0} for b in COMPONENTS
        }
        for n in self.nodes:
            out[n.backend]["flops"] += n.flops
            out[n.backend]["bytes"] += n.bytes
            out[n.backend]["nodes"] += 1
        return out

    def product_flops(self) -> float:
        return sum(n.flops for n in self.nodes if n.product)

    def to_dot(self, max_nodes: int = 200) -> str:
        colors = {TENSOR_CORE: "tomato", CUDA_CORE: "gold", HBM: "skyblue", NVLINK: "violet",
                  HOST: "gray"}
        lines = ["digraph sdfg {", "  rankdir=TB;"]
        for n in self.nodes[:max_nodes]:
            lines.append(
                f'  n{n.id} [label="{n.primitive}\\n{n.backend}" '
                f'style=filled fillcolor={colors[n.backend]}];'
            )
        shown = {n.id for n in self.nodes[:max_nodes]}
        for e in self.edges:
            if e.src in shown and e.dst in shown:
                lines.append(f"  n{e.src} -> n{e.dst};")
        lines.append("}")
        return "\n".join(lines)


class Recorder:
    """Collects the nodes and edges of one run (``extract``)."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.edges: list[Edge] = []
        self._producer: dict[int, tuple[weakref.ref, int]] = {}

    def _add(self, node: Node, ins: list[torch.Tensor], outs: list[torch.Tensor]) -> None:
        self.nodes.append(node)
        for t in ins:
            src = self._producer.get(id(t))
            if src is not None and src[0]() is t:
                self.edges.append(Edge(src[1], node.id, float(_tensor_bytes(t))))
        for t in outs:
            self._producer[id(t)] = (weakref.ref(t), node.id)

    def op(self, func: Any, args: Any, kwargs: Any, out: Any) -> None:
        prim = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        backend, product = (HBM, False) if func.is_view else classify(prim, ins + outs)
        if func.is_view or prim in _FREE_PRIMS:
            flops = nbytes = 0.0
        else:
            nbytes = float(sum(_tensor_bytes(t) for t in ins + outs))
            if product:
                flops = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            elif backend != CUDA_CORE:
                flops = 0.0
            elif prim in _REDUCTIONS:
                flops = float(sum(t.numel() for t in ins))
            else:
                flops = float(sum(t.numel() for t in outs))
        self._add(Node(len(self.nodes), prim, backend, flops, nbytes,
                       scopes.current() or "<toplevel>", product=product), ins, outs)

    def kernel(self, name: str, ins: Iterable[torch.Tensor], outs: Iterable[torch.Tensor],
               flops: float, *, product: bool) -> None:
        """One launch of a port kernel: ``ins`` read once, ``outs`` written once."""
        ins, outs = list(ins), list(outs)
        low = product and ins[0].dtype in _LOW_PRECISION
        backend = TENSOR_CORE if low else CUDA_CORE
        nbytes = float(sum(_tensor_bytes(t) for t in ins + outs))
        self._add(Node(len(self.nodes), name, backend, float(flops), nbytes,
                       scopes.current() or "<toplevel>", product=product, kernel=True),
                  ins, outs)


# The recorder of the running ``extract``, if any: ``kernels/ops.py`` reads it.
ACTIVE: Optional[Recorder] = None


class _RecordMode(TorchDispatchMode):
    def __init__(self, recorder: Recorder) -> None:
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.recorder.op(func, args, kwargs, out)
        return out


def extract(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> SDFG:
    """Run ``fn(*args, **kwargs)`` once and return its SDFG."""
    global ACTIVE
    rec, prev = Recorder(), ACTIVE
    ACTIVE = rec
    try:
        with _RecordMode(rec):
            fn(*args, **kwargs)
    finally:
        ACTIVE = prev
    return SDFG(rec.nodes, rec.edges)
