"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base; unverified] — 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 (per expert) vocab=100352.  264 GB in bf16: more than one H100
holds, so the card serves it at full width cut to its first 8 layers
(54.6 GB; ``chip_smoke.py``).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    layer_pattern=(LayerSpec("ga", "moe"),),
    moe=MoEConfig(
        n_experts=16,
        top_k=4,
        n_shared=0,
        d_expert=10752,
        capacity_factor=1.25,
    ),
    rope_theta=500_000.0,
    tied_embeddings=False,
    act="silu",
)
