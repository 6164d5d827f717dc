"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port knows every architecture of ``repro.configs``: the ``ga`` /
``swa`` architectures with dense or MoE FFNs (gemma2-27b and gemma3-4b
with their softcaps, post-block norms, scaled embeddings and head dim 256;
chameleon-34b with QK-norm and musicgen-large, each with its frontend
stub), the RWKV6 architecture and the hybrid Mamba/attention architecture
(jamba).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, LayerSpec, MambaConfig, ModelConfig, MoEConfig,
                                      RWKVConfig, ShapeConfig, reduced, supports_shape)

_ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-1.5-large": "repro_torch.configs.jamba_1_5_large",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


__all__ = ["SHAPES", "LayerSpec", "MambaConfig", "ModelConfig", "MoEConfig", "RWKVConfig",
           "ShapeConfig", "get_config", "list_archs", "reduced", "supports_shape"]
