"""Config schema: the port's own copy of ``repro/configs/base.py``.

One decoder-LM schema covers the architectures through a *layer pattern*, a
periodic sequence of (mixer, ffn) block kinds.  Parameters are stacked per
pattern position over the periods; the port walks the stacked axis with a
Python loop.

The copy holds the fields the ported serving path reads; each has the JAX
package's name, default and meaning.  Training and sharding fields arrive
with the slices that read them (ROADMAP M9, M13).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Mixer = Literal["ga", "swa", "mamba", "rwkv"]  # global attn / sliding-window attn / SSM / RWKV6
Ffn = Literal["dense", "moe", "rwkv_ffn", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "ga"
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0  # always-on shared experts (DeepSeekMoE)
    d_expert: int = 0  # per-expert FFN width (fine-grained experts)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # jitter etc. omitted: deterministic routing for reproducibility


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # chunked-scan block length: a full-sequence T must divide by min(chunk, T)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # low-rank dim of the data-dependent decay MLP (RWKV6 "Finch")
    mix_lora: int = 32  # low-rank dim of the token-shift mix MLPs
    chunk: int = 128  # chunked-scan block length: a full-sequence T must divide by min(chunk, T)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    first_k_dense: int = 0  # first k layers forced to (pattern[0].mixer, dense)
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    qkv_bias: bool = False  # Qwen2
    qk_norm: bool = False  # Chameleon
    attn_logit_softcap: Optional[float] = None  # Gemma-2
    final_logit_softcap: Optional[float] = None  # Gemma-2
    post_block_norms: bool = False  # Gemma-2/3 post-attn/post-ffn RMSNorms
    scale_embedding: bool = False  # Gemma: multiply embeddings by sqrt(d_model)
    tied_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    frontend: str = "text"  # text | vlm_stub | audio_stub
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # Sharding knobs of the JAX package (GSPMD head padding, activation
    # constraints, sequence-sharded decode).  On one card they change
    # nothing; the port accepts them so a JAX config carries over.
    pad_heads_to: int = 0
    activation_constraints: bool = False
    decode_split_kv: bool = False

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def layer_spec(self, i: int) -> LayerSpec:
        if i < self.first_k_dense:
            return LayerSpec(mixer=self.layer_pattern[i % self.period].mixer, ffn="dense")
        return self.layer_pattern[i % self.period]

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.first_k_dense) // self.period


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """Smoke-test variant: same family/pattern, tiny dims, runs on 1 CPU."""
    n_layers = layers if layers is not None else max(cfg.first_k_dense + cfg.period, 2)
    changes: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=16,
        param_dtype="float32",
        activation_dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            d_expert=32 if cfg.moe.d_expert else 0,
        )
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    if cfg.rwkv is not None:
        changes["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, decay_lora=8, mix_lora=8,
                                              chunk=16)
    return dataclasses.replace(cfg, **changes)
