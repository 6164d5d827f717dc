"""gemma2-27b [dense]: local+global alternating, logit softcapping.

[arXiv:2408.00118; hf] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  head_dim=128 (published).  attn softcap 50.0, final softcap
30.0, post-block RMSNorms, sliding window 4096 on local layers.  27.23 B
parameters: 54.45 GB in bf16, so one card holds it at full depth.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=(LayerSpec("swa"), LayerSpec("ga")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norms=True,
    scale_embedding=True,
    tied_embeddings=True,
    act="gelu",
)
