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

Nothing here imports JAX, so every name is imported eagerly.
"""
from repro_torch.dispatch.cost import (
    CostEstimate,
    estimate_callable,
    estimate_region,
    estimate_sdfg,
)
from repro_torch.dispatch.dispatcher import (
    DispatchConfig,
    DispatchDecision,
    Dispatcher,
    with_impl,
)
from repro_torch.dispatch.profiles import ProfileStore, signature
from repro_torch.dispatch.registry import (
    BackendRegistry,
    BackendTarget,
    default_registry,
    host_registry,
)

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
