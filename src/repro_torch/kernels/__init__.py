"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the dispatch layer (``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the card
(a CPU tensor takes the plain version and counts nothing), so a run can show
that its main path went through the kernels.

A CUDA graph splits that count from the launches: capturing one runs the
wrappers (which count) but launches nothing, and replaying it launches
kernels without calling a wrapper.  So a capture runs inside
:func:`uncounted`, which hands back what the wrappers counted and takes it
out of ``LAUNCHES`` again, and each replay adds those counts back once
(:func:`add_launches`).  ``LAUNCHES`` then stays the number of kernels the
card ran.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Mapping

LAUNCHES: dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0,
                            "moe_gmm": 0, "rwkv6_scan": 0, "mamba_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


@contextmanager
def uncounted() -> Iterator[dict[str, int]]:
    """Runs a block whose wrapper calls launch nothing (a CUDA graph's
    capture): yields a dict that, after the block, holds the launches the
    wrappers counted in it, and leaves ``LAUNCHES`` as it was before."""
    before = dict(LAUNCHES)
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        for name, n in before.items():
            made[name] = LAUNCHES[name] - n
            LAUNCHES[name] = n


def add_launches(counts: Mapping[str, int], times: int = 1) -> None:
    """Adds ``times`` x ``counts`` to ``LAUNCHES`` (one replay of a graph
    whose capture counted ``counts``, ``times`` times)."""
    for name, n in counts.items():
        LAUNCHES[name] += n * times
