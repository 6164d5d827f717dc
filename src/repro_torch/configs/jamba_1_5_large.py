"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE.

[arXiv:2403.19887; hf] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  Jamba block structure: period 8 with one
attention layer (position 4) per 7 Mamba layers, MoE on every other layer.
398 B parameters, 796 GB in bf16: one card holds the first five layers
(every layer kind of the pattern, 48.1 GB), which is what ``chip_smoke.py``
serves.
"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=(
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("ga", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
    ),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        n_shared=0,
        d_expert=24576,
        capacity_factor=1.25,
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tied_embeddings=False,
    act="silu",
)
