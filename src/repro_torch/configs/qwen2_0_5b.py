"""qwen2-0.5b [dense]: GQA with QKV bias.

[arXiv:2407.10671; hf] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    layer_pattern=(LayerSpec("ga"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tied_embeddings=True,
    act="silu",
)
