"""repro_torch.tune — kernel autotuning on the card via design-space
exploration (counterpart of ``repro/tune/``, with a Hopper design space).

The paper's loop, applied to *configuration* instead of just placement:
measure the design space (launch-plan knobs of the Hopper kernels, the plain
tier's scan chunks), prune it with the roofline model, time the survivors,
and publish the winners through the fleet so one card's sweep warm-starts
every later run on matching code and hardware.

    space.py     candidate config grids per (op, tier), launch-limit aware
    prune.py     roofline pruning (never cuts the shipped default)
    explore.py   the sweep + winner application (``driver_tune``)
    cli.py       ``python -m repro_torch.tune {sweep,show,spaces}``

Nothing here imports ``torch`` at import time (nor does a ``synthetic``
sweep): the fleet daemon and CPU jobs enumerate spaces without it; real
and interpret measurement import it inside the sweep.
"""
from repro_torch.tune.explore import (
    Explorer,
    SweepSettings,
    apply_winners,
    driver_tune,
    winners_from_store,
)
from repro_torch.tune.prune import DEFAULT_PRUNE_RATIO, RooflinePruner
from repro_torch.tune.space import ConfigPoint, KernelSpace, default_spaces

__all__ = [
    "ConfigPoint",
    "DEFAULT_PRUNE_RATIO",
    "Explorer",
    "KernelSpace",
    "RooflinePruner",
    "SweepSettings",
    "apply_winners",
    "default_spaces",
    "driver_tune",
    "winners_from_store",
]
