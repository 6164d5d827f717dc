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

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on; raises if CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
