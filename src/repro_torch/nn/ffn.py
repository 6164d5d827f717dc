"""FFN blocks: the dense gated GLU and GShard-style MoE with capacity routing
(counterpart of ``repro/nn/ffn.py``).

The MoE layer routes each group of tokens top-k into per-expert capacity
buckets, runs the experts as one grouped gated FFN (``ops.moe_ffn``: three
launches of the grouped-matmul kernel on the card) and combines the
outputs with the router's gates.  It follows the JAX package's code to the
token: which expert each token picks, which picks overflow a bucket and are
dropped, and each gate.  Where the JAX package dispatches and combines with
dense one-hot einsums, the port gathers and scatters rows; each (expert,
slot) holds at most one token, so the dispatch is exact.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.nn import core as nn

# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def ffn_init(pf: nn.ParamFactory, cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    return {
        "w1": nn.linear_init(pf, (D,), (F,)),
        "w3": nn.linear_init(pf, (D,), (F,)),
        "w2": nn.linear_init(pf, (F,), (D,), scale=out_scale),
    }


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = nn.ACTIVATIONS[cfg.act]
    h = act(nn.linear(p["w1"], x).float()) * nn.linear(p["w3"], x).float()
    return nn.linear(p["w2"], h.to(x.dtype))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_init(pf: nn.ParamFactory, cfg: ModelConfig) -> dict:
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: an moe layer needs cfg.moe")
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_expert or cfg.d_ff
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    p = {
        "router": nn.linear_init(pf, (D,), (E,), scale=0.02),
        "w1": pf.param((E, D, F)),
        "w3": pf.param((E, D, F)),
        "w2": pf.param((E, F, D), scale=out_scale),
    }
    if m.n_shared:
        p["shared"] = ffn_init(pf, cfg, d_ff=m.n_shared * F)
    return p


def _capacity(group: int, m: MoEConfig) -> int:
    c = math.ceil(group * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # pad to a multiple of 8, as the JAX package does


def pick_group_size(n_tokens: int, target: int = 2048) -> int:
    """Largest divisor of n_tokens that is <= target (prefer big groups)."""
    g = min(n_tokens, target)
    while n_tokens % g:
        g -= 1
    return g


def moe_apply(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, group_size: Optional[int] = None
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux_losses).

    GShard top-k capacity routing with deterministic overflow dropping:
    gates are renormalised over all top-k picks, then zeroed for dropped
    ones; a bucket fills in priority (choice rank, token position).
    """
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe_apply needs cfg.moe")
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    G = group_size or pick_group_size(T)
    n_g = T // G
    C = _capacity(G, m)
    dev = x.device

    # router: the product rounded to x's dtype, then softmax in f32
    logits = nn.linear(p["router"], x.reshape(n_g, G, D)).float()  # (n_g, G, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k, ties to the lower expert index as jax.lax.top_k breaks them
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :K], idx[..., :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    # A group's K*G picks in priority order (rank-major, then token): a
    # pick's slot in its expert's bucket is the number of earlier picks of
    # that expert, dropped ones included, as the JAX package counts them.
    # (The count runs along the last axis: on the card a scan along the
    # middle axis took 0.56 ms per prefill MoE layer, a sixth of its time.)
    e_pick = idx.transpose(1, 2).reshape(n_g, K * G)
    onehot = e_pick[:, None, :] == torch.arange(E, device=dev)[:, None]  # (n_g, E, K*G)
    slot = onehot.cumsum(-1).gather(1, e_pick[:, None, :])[:, 0, :] - 1
    keep = slot < C

    # dispatch: row e * (n_g * C) + g * C + slot of the experts' input; a
    # dropped pick writes a spare last row, which is cut off
    n_rows = E * n_g * C
    grp = torch.arange(n_g, device=dev)[:, None]
    dest = torch.where(keep, e_pick * (n_g * C) + grp * C + slot, n_rows).reshape(-1)
    token = (grp * G + torch.arange(G, device=dev).repeat(K)).reshape(-1)
    expert_in = x.new_zeros(n_rows + 1, D)
    expert_in[dest] = x.reshape(T, D)[token]
    expert_out = ops.moe_ffn(expert_in[:n_rows].view(E, n_g * C, D), p["w1"], p["w3"],
                             p["w2"], act=cfg.act)

    # combine in f32: each token's kept picks weighted by their gates
    weight = gates.transpose(1, 2).reshape(n_g, K * G) * keep  # 0 for a dropped pick
    picked = expert_out.reshape(n_rows, D)[dest.clamp(max=n_rows - 1)].float()
    y = (picked.view(n_g, K * G, D) * weight[..., None]).view(n_g, K, G, D).sum(1)
    y = y.reshape(B, S, D).to(x.dtype)

    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg)

    # Aux losses (Switch/GShard load-balance + z-loss), f32.  The routed
    # fraction is taken in x's dtype, as the JAX package's dispatch tensor is.
    kept = torch.zeros(n_g, E, dtype=x.dtype, device=dev).scatter_add_(
        1, e_pick, keep.to(x.dtype))
    me = probs.mean(dim=(0, 1))  # (E,) mean router prob
    ce = (kept / G).mean(dim=0).float()  # (E,) fraction routed
    aux = {
        "moe_load_balance": E * torch.sum(me * ce) * m.router_aux_weight,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_weight,
    }
    return y, aux
