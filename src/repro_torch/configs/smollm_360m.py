"""smollm-360m [dense]: llama-arch small model.

[hf:HuggingFaceTB/SmolLM-135M; hf] — 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    layer_pattern=(LayerSpec("ga"),),
    tied_embeddings=True,
    act="silu",
)
