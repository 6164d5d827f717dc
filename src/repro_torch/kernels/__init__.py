"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the dispatch layer (``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the card
(a CPU tensor takes the plain version and counts nothing), so a run can show
that its main path went through the kernels.

Every wrapper launches its kernel through ctypes, outside autograd, so on a
CUDA tensor it refuses an input that needs a gradient (:func:`refuse_grad`,
ROADMAP R11) instead of silently detaching it.  The differentiable route
is ``ops``: ``ops.attention`` and ``ops.rmsnorm`` are
``torch.autograd.Function``s whose backward is a kernel too (K1b, K3b);
the other kernels have no backward kernel yet.

A CUDA graph splits that count from the launches: capturing one runs the
wrappers (which count) but launches nothing, and replaying it launches
kernels without calling a wrapper.  So a capture runs inside
:func:`uncounted`, which hands back what the wrappers counted and takes it
out of ``LAUNCHES`` again, and each replay adds those counts back once
(:func:`add_launches`).  ``LAUNCHES`` then stays the number of kernels the
card ran.

This package module and ``plan`` (the launch plans the tuner prices) import
no ``torch``; the wrappers do.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import TYPE_CHECKING, Iterator, Mapping

if TYPE_CHECKING:
    import torch

LAUNCHES: dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0,
                            "moe_gmm": 0, "rwkv6_scan": 0, "mamba_scan": 0,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                            "decode_attention_stats": 0}


def refuse_grad(kernel: str, instead: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    kernel's output would carry no gradient back to it (ROADMAP R11).
    ``instead`` says what to call instead, or which ROADMAP item brings the
    backward kernel."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input requires grad, but the kernel has no autograd "
                           f"(ROADMAP R11): {instead}; or run it under torch.no_grad()")


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
