"""Config schema: the port's own copy of ``repro/configs/base.py``.

One decoder-LM schema covers the architectures through a *layer pattern*, a
periodic sequence of (mixer, ffn) block kinds.  Parameters are stacked per
pattern position over the periods; the port walks the stacked axis with a
Python loop.

The copy holds the fields the ported serving, training and dry-run paths
read; each has the JAX package's name, default and meaning.  So do the four
LM shapes (``SHAPES``) and ``supports_shape``, the dry-run's skip rule.
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
    # training: the final-logit z-loss, the optimizer moments' storage
    # dtype, per-period rematerialisation (nothing | dots | everything = no
    # remat) and the token chunk of the cross-entropy
    z_loss_weight: float = 1e-4
    moment_dtype: str = "float32"
    remat_policy: str = "nothing"
    loss_chunk: int = 1024
    # profiling (the paper's technique): static tracepoints in the step when
    # enabled; see core/tracepoints.py (carried, as in the JAX package)
    tracepoints: bool = False
    # Carried so that a JAX config carries over, with no effect here: the
    # backward of attention on the card is always the flash backward (K1b),
    # which is what fused_attention_vjp selects in the JAX package;
    # chunk_scan_remat checkpoints the Mamba / RWKV chunked scans, which
    # have no backward on the card yet (ROADMAP K5b, K6b); pad_heads_to pads
    # GSPMD's head axis.
    fused_attention_vjp: bool = False
    chunk_scan_remat: bool = False
    pad_heads_to: int = 0
    # Sharding knobs (distributed/), acting under an ambient mesh only:
    # loss_table_replicated gathers the unembed table's embed dim once in
    # the loss; activation_constraints constrains the prefill's q / k / v by
    # logical axes; decode_split_kv combines K2's partials across the
    # devices a decode cache's sequence is sharded over (decode_seq_axes),
    # its batch over decode_batch_axes.  Without a mesh they change nothing.
    loss_table_replicated: bool = False
    activation_constraints: bool = False
    decode_split_kv: bool = False
    decode_seq_axes: tuple = ("model",)
    decode_batch_axes: tuple = ("pod", "data")

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

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer in ("ga", "swa") for s in self.layer_pattern)

    @property
    def pure_full_attention(self) -> bool:
        """True if every mixer is global attention (no locality / recurrence)."""
        return all(s.mixer == "ga" for s in self.layer_pattern)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The JAX package's four LM shapes; decode_* / long_* run the decode step.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (the JAX package's rule)."""
    if shape.name == "long_500k" and cfg.pure_full_attention:
        return False, (
            f"{cfg.name} is pure full-attention; a 512k dense KV cache has no "
            "locality/recurrence structure — skipped per assignment"
        )
    return True, ""


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
        loss_chunk=32,
        param_dtype="float32",
        activation_dtype="float32",
        moment_dtype="float32",
        remat_policy="everything",
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
