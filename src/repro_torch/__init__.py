"""PyTorch/CUDA port of the ``repro`` serving path for one NVIDIA H100.

The package mirrors ``repro``'s module paths (``repro_torch/nn/attention.py``
is the counterpart of ``repro/nn/attention.py``, and so on).  It imports
``torch``, numpy and the standard library only: never ``jax`` and never a
module of ``repro``.  What it needs from a jax-free ``repro`` module (the
config dataclasses, the event log) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
asking for ``cuda`` without a card raises instead of dropping to the CPU.
"""
from __future__ import annotations


def resolve_device(device: str | torch.device = "cuda") -> torch.device:  # noqa: F821
    """The torch device an entry point runs on; raises if CUDA is absent.
    ``torch`` is imported here, not with the package: the router, the fleet
    daemon and the trace CLI import ``repro_torch`` without it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
