"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.

[arXiv:2404.05892; hf] — 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
64 WKV heads of size 64; token-shift with data-dependent (LoRA) mixing;
per-channel data-dependent decay w_t.  O(1)-state decode — the designated
long_500k architecture.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / rwkv.head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=(LayerSpec("rwkv", "rwkv_ffn"),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    tied_embeddings=False,
    act="silu",
)
