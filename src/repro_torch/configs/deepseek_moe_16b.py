"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf] — 28L d_model=2048 16H (GQA kv=16, i.e. MHA)
d_ff=1408 (per fine-grained expert) vocab=102400.  Layer 0 is a dense FFN
(width 10944, the published DeepSeekMoE-16B value); remaining 27 layers are
MoE.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense layer-0 width; expert width is moe.d_expert
    vocab_size=102400,
    layer_pattern=(LayerSpec("ga", "moe"),),
    first_k_dense=1,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_expert=1408,
        capacity_factor=1.25,
    ),
    tied_embeddings=False,
    act="silu",
)
