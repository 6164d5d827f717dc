"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] — 48L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=2048.  The EnCodec neural-codec frontend is a stub:
precomputed (B, S, d_model) frame embeddings (the 4-codebook delay pattern
collapsed to one summed stream) go through a learned projection and are
added to the token embeddings (``nn/frontend.py``).  3.24 B parameters:
6.5 GB in bf16.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=(LayerSpec("ga"),),
    tied_embeddings=False,
    frontend="audio_stub",
    act="gelu",
)
