"""Roofline pruning: cut the design space before any timing happens.

Counterpart of ``repro/tune/prune.py``, unchanged.  The sweep's cost is
dominated by measured points (each pays warmup + repeats of a real kernel
execution); the roofline model is free.  So the pruner prices every
candidate a priori and drops the ones predicted worse than ``ratio`` x the
best prediction — the "achievable bound" for this space.

Two safety rails:

* the shipped **default point is never pruned** — the tuner's claim is
  "measured winner beats the shipped default", which is only meaningful if
  the default was measured in the same sweep;
* ``ratio`` is deliberately loose (4x by default): the model only has to be
  right about *order of magnitude*, not ranking — a point the model misprices
  by less than the ratio still gets timed, so the measured argmin corrects
  the model (measured-beats-estimated, same contract as the dispatcher).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.hw.specs import ChipSpec, default_chip
from repro_torch.tune.space import ConfigPoint, KernelSpace

DEFAULT_PRUNE_RATIO = 4.0


@dataclasses.dataclass(frozen=True)
class PrunedPoint:
    point: ConfigPoint
    predicted_s: float
    bound_s: float


class RooflinePruner:
    """Keep candidates predicted within ``ratio`` x the space's best point."""

    def __init__(self, chip: Optional[ChipSpec] = None,
                 ratio: float = DEFAULT_PRUNE_RATIO) -> None:
        if ratio < 1.0:
            raise ValueError(f"prune ratio must be >= 1.0, got {ratio}")
        self.chip = chip or default_chip()
        self.ratio = ratio

    def prune(
        self, space: KernelSpace, points: list[ConfigPoint]
    ) -> tuple[list[ConfigPoint], list[PrunedPoint]]:
        """Split candidates into (survivors, pruned); order preserved."""
        if not points:
            return [], []
        predicted = {p.config: space.roofline_s(p.params, self.chip) for p in points}
        bound = min(predicted.values())
        kept: list[ConfigPoint] = []
        cut: list[PrunedPoint] = []
        for p in points:
            if p.config == space.default_config or predicted[p.config] <= self.ratio * bound:
                kept.append(p)
            else:
                cut.append(PrunedPoint(p, predicted[p.config], bound))
        return kept, cut
