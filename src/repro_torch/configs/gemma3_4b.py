"""gemma3-4b [dense]: 5:1 local:global interleave, head dim 256.

[hf:google/gemma-3-1b-pt; unverified] — 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144.  head_dim=256 (the published Gemma-3 head size;
n_heads * head_dim = 2048 != d_model by design).  Sliding window 1024 on
local layers; every 6th layer is global.  34 layers are 5 periods of
(swa x 5, ga) and a tail of 4 swa layers, which ``models/lm.py`` runs
unscanned.  3.88 B parameters: 7.8 GB in bf16.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layer_pattern=(
        LayerSpec("swa"),
        LayerSpec("swa"),
        LayerSpec("swa"),
        LayerSpec("swa"),
        LayerSpec("swa"),
        LayerSpec("ga"),
    ),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    post_block_norms=True,  # Gemma-3 sandwich norms
    scale_embedding=True,
    tied_embeddings=True,
    act="gelu",
)
