"""chameleon-34b [vlm]: early fusion over VQ image tokens, QK-norm.

[arXiv:2405.09818; unverified] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536.  QK-norm (the paper's divergence fix): an RMSNorm over each
query and key head after the projections.  The VQ-VAE image tokenizer is a
stub: precomputed (B, S, d_model) embeddings go through a learned
projection and are added to the token embeddings (``nn/frontend.py``).
34.36 B parameters: 68.7 GB in bf16.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    layer_pattern=(LayerSpec("ga"),),
    qk_norm=True,
    tied_embeddings=False,
    frontend="vlm_stub",
    act="silu",
)
