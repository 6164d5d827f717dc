"""Profile-guided dispatch on the card — closing the paper's loop.

Counterpart of ``repro/dispatch/``.  The source paper motivates performance
analysis as the input to *placement*: "determining the most suitable
platform for dispatching tasks".  The port measures (``core/``: probes,
tracepoints, SDFG, roofline); this package acts on the measurements,
choosing per call between the two tiers every op of ``kernels/ops.py``
has, the hand-written Hopper kernels and their plain PyTorch versions:

    registry.py    the dispatch targets (kernel, plain) with static cost
                   factors cited from measured kernel times
    cost.py        a-priori pricing of an SDFG region per target (roofline)
    profiles.py    online profile store — measured samples override
                   estimates once warm (the same JSON as the JAX package's)
    dispatcher.py  argmin-cost routing of serving steps and train steps,
                   every decision recorded as a ``dispatch`` event

Typical use::

    from repro_torch.dispatch import Dispatcher, DispatchConfig, host_registry

    disp = Dispatcher(DispatchConfig(policy="profiled"), registry=host_registry(device=dev))
    out = disp.dispatch("serve_decode", {"kernel": f1, "plain": f2}, *args)

``profiles`` imports no ``torch``; the other modules do, so they are
re-exported lazily (PEP 562), as the JAX package re-exports its jax
modules: the fleet daemon and the router read profile stores without
``torch``.
"""
from repro_torch.dispatch.profiles import ProfileStore, signature

_LAZY = {
    "CostEstimate": "repro_torch.dispatch.cost",
    "estimate_callable": "repro_torch.dispatch.cost",
    "estimate_region": "repro_torch.dispatch.cost",
    "estimate_sdfg": "repro_torch.dispatch.cost",
    "DispatchConfig": "repro_torch.dispatch.dispatcher",
    "DispatchDecision": "repro_torch.dispatch.dispatcher",
    "Dispatcher": "repro_torch.dispatch.dispatcher",
    "with_impl": "repro_torch.dispatch.dispatcher",
    "BackendRegistry": "repro_torch.dispatch.registry",
    "BackendTarget": "repro_torch.dispatch.registry",
    "default_registry": "repro_torch.dispatch.registry",
    "host_registry": "repro_torch.dispatch.registry",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "BackendRegistry",
    "BackendTarget",
    "CostEstimate",
    "DispatchConfig",
    "DispatchDecision",
    "Dispatcher",
    "ProfileStore",
    "default_registry",
    "estimate_callable",
    "estimate_region",
    "estimate_sdfg",
    "host_registry",
    "signature",
    "with_impl",
]
