"""Weight bridge: the JAX package's param tree -> the port's.

``params_from_jax`` takes the tree of ``repro.models.lm.init_params`` (or a
checkpoint) as nested dicts of **numpy** arrays, e.g.
``jax.tree.map(np.asarray, params)``, so this module imports no JAX.  The
trees have the same keys and layouts, including each per-period stacked
leaf ``blocks/pos{i}/...`` with its leading ``n_periods`` axis.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross as their ``uint16`` bit patterns and
are reinterpreted as ``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig, device: str | torch.device = "cuda") -> dict:
    """Convert a JAX param tree of numpy arrays into the port's tensors on
    ``device`` (``cuda`` without a card raises)."""
    device = resolve_device(device)
    def conv(tree: Any, path: str) -> Any:
        if isinstance(tree, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in tree.items()}
        t = _tensor(tree, device)
        if path.startswith("/blocks/") and (t.dim() == 0 or t.shape[0] != cfg.n_periods):
            raise ValueError(f"{path}: stacked leaf {tuple(t.shape)} lacks its leading "
                             f"n_periods={cfg.n_periods} axis")
        return t

    return conv(np_params, "")
