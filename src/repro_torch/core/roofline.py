"""Roofline for one card: the counterpart of ``repro/core/roofline.py``.

``analyze_step(fn, *args)`` runs ``fn`` once and prices what it did on the
H100 (``hw/specs.py``):

    compute term = FLOPs / peak FLOP/s     (tensor-core products at the bf16
                                            peak, everything else at the f32 one)
    memory term  = bytes / HBM bandwidth

FLOPs and bytes come from the SDFG record of the run (``core/sdfg.py``:
every aten op the dispatcher saw, and every kernel the port's ``ops``
entries launched), in place of the JAX package's walk of the optimized HLO
(``repro/core/hloanalysis.py``).  The larger term is the bottleneck and
``step_time_bound_s``, the least time the card could take for the same
ops.  On one card there is no collective term.

``model_flops`` is the yardstick of useful work (the numerator of the
model FLOP utilisation), arithmetic for arithmetic the JAX package's:
6·N_active·T for a train step (2· for serving) plus the attention term and
the unembedding, the embedding lookup excluded.  It counts the unembedding
for every token of a prefill, where the serving path computes logits at
the last position only.  ``count_params`` takes any tree of tensors,
meta-device ones included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.hw.specs import ChipSpec, default_chip


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The JAX package's four LM shapes (repro/configs/base.py).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def analyze_step(fn: Callable[..., Any], *args: Any, chip: Optional[ChipSpec] = None,
                 **kwargs: Any) -> dict:
    """Roofline record of one call of ``fn`` (terms in seconds)."""
    from repro_torch.core import sdfg

    chip = chip or default_chip()
    graph = sdfg.extract(fn, *args, **kwargs)
    summary = graph.summary()
    flops = sum(c["flops"] for c in summary.values())
    tc_flops = summary[sdfg.TENSOR_CORE]["flops"]
    bytes_accessed = sum(c["bytes"] for c in summary.values())
    t_compute = tc_flops / chip.peak_flops_bf16 + (flops - tc_flops) / chip.peak_flops_f32
    t_memory = bytes_accessed / chip.hbm_bw
    terms = {"compute": t_compute, "memory": t_memory}
    bottleneck = max(terms, key=terms.get)
    return {
        "flops": flops,
        "tensor_core_flops": tc_flops,
        "product_flops": graph.product_flops(),
        "bytes": bytes_accessed,
        "nodes": len(graph.nodes),
        "kernel_nodes": sum(n.kernel for n in graph.nodes),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "bottleneck": bottleneck,
        "step_time_bound_s": max(terms.values()),
        "by_component": summary,
        "chip": chip.name,
        "sdfg": graph,
    }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def _named_leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):  # jax.tree's order: sorted keys
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def count_params(params: Any, *, active: bool, cfg: ModelConfig) -> int:
    """Param count; ``active`` scales expert tensors by (top_k / n_experts)."""
    total = 0.0
    for keys, leaf in _named_leaves(params):
        n = leaf.numel()
        if (active and cfg.moe and "/ffn/w" in keys and leaf.dim() >= 3
                and leaf.shape[-3] == cfg.moe.n_experts):
            n = n * cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return int(total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig, params: Any) -> float:
    """Analytic useful FLOPs a step: 6·N_active·T (2· for serving) + the
    attention quadratic term + the unembed product; embedding lookup
    excluded."""
    n_active = count_params(params, active=True, cfg=cfg)
    n_embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tied_embeddings else 2)
    n_matmul = max(n_active - n_embed, 0)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        T = B * S
        base = 6.0 * n_matmul * T + 3 * 2.0 * T * cfg.d_model * cfg.vocab_size
        attn_mult = 3  # fwd + bwd
        tokens_sq = _attn_token_pairs(cfg, S, causal=True) * B
    elif shape.kind == "prefill":
        T = B * S
        base = 2.0 * n_matmul * T + 2.0 * T * cfg.d_model * cfg.vocab_size
        attn_mult = 1
        tokens_sq = _attn_token_pairs(cfg, S, causal=True) * B
    else:  # decode: one token vs a cache of S
        T = B
        base = 2.0 * n_matmul * T + 2.0 * T * cfg.d_model * cfg.vocab_size
        attn_mult = 1
        tokens_sq = _attn_token_pairs(cfg, S, causal=False, decode=True) * B
    attn = attn_mult * 4.0 * cfg.n_heads * cfg.head_dim * tokens_sq
    return base + attn


def _attn_token_pairs(cfg: ModelConfig, S: int, *, causal: bool, decode: bool = False) -> float:
    """Sum over attention layers of the (q, kv) pair count."""
    pairs = 0.0
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        if spec.mixer not in ("ga", "swa"):
            continue
        w = cfg.sliding_window if spec.mixer == "swa" else None
        if decode:
            pairs += min(w, S) if w else S
        elif w and w < S:
            pairs += S * w - w * (w - 1) / 2  # causal within window
        else:
            pairs += S * (S + 1) / 2 if causal else S * S
    return pairs
