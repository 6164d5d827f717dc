"""Dynamic probes: the Uprobes analogue, counterpart of ``repro/core/uprobes.py``.

A uprobe attaches to an *unmodified* binary at a symbol: the kernel
patches a trap into the text page, and the handler runs on every hit.  The
port attaches at the two places where a PyTorch program can be hooked
without a source change:

1. **Python symbol interception** (``ProbeRegistry.attach`` /
   ``detach_all``): a function is wrapped *in its defining module*, as an
   ELF symbol is.  Every call records ``<module>.<name>:enter`` and
   ``:exit`` host events and, between them, the trap ``:ret``: the first
   element of the first floating-point output, read to the host (a sync).
   The model calls its kernels as ``ops.<name>`` and its norms as
   ``nn.rmsnorm``, so ``attach(ops, "attention")`` probes K1 and
   ``attach(nn_core, "rmsnorm")`` every RMSNorm.
2. **Op interception** (``inject_probes``): ``fn`` runs under a
   ``TorchDispatchMode`` that fires a probe at every aten op the matcher
   accepts.  The op's name (``by_primitive``) and the named-scope path it
   ran in (``by_scope``, ``core/scopes.py``) play the role of the symbol
   table, as the jaxpr's primitives and name stacks do in JAX.

What the dispatch mode cannot see: the port's kernels launch through ctypes
(``kernels/_build.py``), outside the dispatcher, so on the card the mode
sees only the ops around a kernel (the ``torch.empty`` of its output, the
views of its inputs), never the kernel itself.  Kernels are probed by
mechanism 1 on their ``ops`` entry, just as the JAX package's uprobes
reach a Pallas kernel only through the symbol that calls it.

Both mechanisms read values to the host in their traps, which is why
uprobe-style instrumentation shifts cost into host and system time in the
overhead study, the paper's Fig. 2 finding.  A trap cannot run inside a
CUDA graph capture: it raises there (``kernels._build.refuse_in_capture``).
"""
from __future__ import annotations

import dataclasses
import time
from functools import wraps
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import scopes
from repro_torch.core.events import GLOBAL_LOG, EventLog
from repro_torch.core.tracepoints import NO_SYNC
from repro_torch.kernels._build import refuse_in_capture


def _first_float(out: Any) -> Optional[torch.Tensor]:
    return next((t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.numel() > 0), None)


# --------------------------------------------------------------------------
# 1. Python-symbol interception
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Attachment:
    module: Any
    name: str
    original: Callable


class ProbeRegistry:
    """Attach and detach dynamic probes on module-level functions."""

    def __init__(self, log: EventLog | None = None) -> None:
        self.log = GLOBAL_LOG if log is None else log  # (EventLog is falsy when empty)
        self._attached: list[_Attachment] = []

    def attach(self, module: Any, name: str) -> None:
        """Instrument ``module.name`` in place.  No source change required."""
        original = getattr(module, name)
        if getattr(original, "__repro_probe__", False):
            return  # already attached
        log = self.log
        target = f"{getattr(module, '__name__', module)}.{name}"

        @wraps(original)
        def probed(*args: Any, **kwargs: Any):
            log.record("probe", target + ":enter", time.monotonic())
            out = original(*args, **kwargs)
            leaf = _first_float(out)
            if leaf is not None:
                # a register-sized probe argument, not a reduction over the
                # tensor: the first element, read to the host
                refuse_in_capture(f"the uprobe on {target} {NO_SYNC}")
                log.record("probe", target + ":ret", leaf.reshape(-1)[0].float().item())
            log.record("probe", target + ":exit", time.monotonic())
            return out

        probed.__repro_probe__ = True  # type: ignore[attr-defined]
        setattr(module, name, probed)
        self._attached.append(_Attachment(module, name, original))

    def detach_all(self) -> None:
        while self._attached:
            a = self._attached.pop()
            setattr(a.module, a.name, a.original)

    def __enter__(self) -> "ProbeRegistry":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.detach_all()


# --------------------------------------------------------------------------
# 2. Op interception
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One dispatched aten op: ``op`` as ``aten.mm.default``, ``primitive``
    as ``mm``, and the scope path it ran in."""

    op: str
    primitive: str
    scope: str


def op_site(func: Any) -> OpSite:
    return OpSite(str(func), func.overloadpacket.__name__, scopes.current())


def by_primitive(*names: str) -> Callable[[OpSite], bool]:
    """Match ops by name: the packet (``mm``) or the overload (``aten.mm.default``)."""
    names_set = set(names)

    def matcher(site: OpSite) -> bool:
        return site.primitive in names_set or site.op in names_set

    return matcher


def by_scope(substring: str) -> Callable[[OpSite], bool]:
    """Match ops whose named-scope path contains ``substring``."""

    def matcher(site: OpSite) -> bool:
        return substring in site.scope

    return matcher


class _ProbeMode(TorchDispatchMode):
    def __init__(self, matcher: Callable[[OpSite], bool], probe: Callable) -> None:
        super().__init__()
        self.matcher = matcher
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site = op_site(func)
        if self.matcher(site):
            self.probe(site, out)
        return out


def inject_probes(
    fn: Callable,
    matcher: Callable[[OpSite], bool],
    *,
    mode: str = "callback",
    log: EventLog | None = None,
) -> Callable:
    """Return ``fn`` with probes at the ops ``matcher`` accepts.

    ``mode="callback"`` records each probe's value on the host (uprobe trap
    semantics; a sync per hit); ``mode="tap"`` returns ``(out, taps)``,
    ``taps = {"<primitive>#<hit>": 0-dim f32 tensor}`` (for deterministic
    tests).  The probe reads the first element of the op's first
    floating-point output; ops without one are passed over.
    """
    if mode not in ("callback", "tap"):
        raise ValueError(f"mode must be 'callback' or 'tap', got {mode!r}")
    log = GLOBAL_LOG if log is None else log

    def probed(*args: Any, **kwargs: Any):
        taps: dict[str, torch.Tensor] = {}
        counter = [0]

        def probe(site: OpSite, out: Any) -> None:
            name = f"{site.primitive}#{counter[0]}"
            counter[0] += 1
            leaf = _first_float(out)
            if leaf is None:
                return
            # a register-sized argument, not a tensor reduction (uprobe semantics)
            summary = leaf.reshape(-1)[0].to(torch.float32, copy=True)
            if mode == "callback":
                refuse_in_capture(f"the injected probe {name} {NO_SYNC}")
                log.record("probe", name, summary.item())
            else:
                taps[name] = summary

        with _ProbeMode(matcher, probe):
            out = fn(*args, **kwargs)
        return (out, taps) if mode == "tap" else out

    return probed
