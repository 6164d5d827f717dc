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

The routing's backward accumulates with no unordered atomics: the
gathers ``x[token]`` (each token top-k times) and the combine's
``expert_out[dest]`` differentiate to ``index_put`` with accumulation,
which on the card sorts its indices first and sums each row's
contributions in that order (``indexing_backward_kernel``), and the
sort's backward scatters to distinct slots.  So a step's gradients are
the same bits on every run, and a replayed train step equals the eager
one (``chip_smoke.py`` phase 5 (l)).  The experts' FFN differentiates
through K4b (``ops.MoEFFN``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.constrain import is_dtensor
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
        "w1": nn.linear_init(pf, (D,), (F,), ("embed",), ("mlp",)),
        "w3": nn.linear_init(pf, (D,), (F,), ("embed",), ("mlp",)),
        "w2": nn.linear_init(pf, (F,), (D,), ("mlp",), ("embed",), scale=out_scale),
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
        "router": nn.linear_init(pf, (D,), (E,), ("embed",), ("experts",), scale=0.02),
        "w1": pf.param((E, D, F), ("experts", "embed", "expert_mlp")),
        "w3": pf.param((E, D, F), ("experts", "embed", "expert_mlp")),
        "w2": pf.param((E, F, D), ("experts", "expert_mlp", "embed"), scale=out_scale),
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

    On DTensors (a step on a mesh) the routing runs on each rank's own token
    rows (:func:`_moe_apply_sharded`).
    """
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe_apply needs cfg.moe")
    if is_dtensor(x):
        return _moe_apply_sharded(p, x, cfg, group_size)
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = group_size or pick_group_size(T)
    n_g = T // G
    C = _capacity(G, m)
    logits, probs, gates, e_pick, keep, dest, expert_in = _route(p["router"], x.reshape(T, D),
                                                                 m, n_g, G, C)
    expert_out = ops.moe_ffn(expert_in, p["w1"], p["w3"], p["w2"], act=cfg.act)
    y = _combine(expert_out, gates, keep, dest, n_g, G, m.top_k).reshape(B, S, D).to(x.dtype)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg)

    # Aux losses (Switch/GShard load-balance + z-loss), f32.  The routed
    # fraction is taken in x's dtype, as the JAX package's dispatch tensor is.
    E = m.n_experts
    kept = torch.zeros(n_g, E, dtype=x.dtype, device=x.device).scatter_add_(
        1, e_pick, keep.to(x.dtype))
    me = probs.mean(dim=(0, 1))  # (E,) mean router prob
    ce = (kept / G).mean(dim=0).float()  # (E,) fraction routed
    aux = {
        "moe_load_balance": E * torch.sum(me * ce) * m.router_aux_weight,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_weight,
    }
    return y, aux


def _route(router: dict, x: torch.Tensor, m, n_g: int, G: int, C: int):
    """Route the (n_g * G, D) tokens in groups of G -> (router logits,
    probs, gates, each pick's expert, kept picks, each pick's row in the
    experts' input, the experts' input (E, n_g * C, D))."""
    T, D = x.shape
    E, K = m.n_experts, m.top_k
    dev = x.device
    # router: the product rounded to x's dtype, then softmax in f32
    logits = nn.linear(router, x.reshape(n_g, G, D)).float()  # (n_g, G, E)
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
    expert_in[dest] = x[token]
    return logits, probs, gates, e_pick, keep, dest, expert_in[:n_rows].view(E, n_g * C, D)


def _combine(expert_out: torch.Tensor, gates: torch.Tensor, keep: torch.Tensor,
             dest: torch.Tensor, n_g: int, G: int, K: int) -> torch.Tensor:
    """Each token's kept picks weighted by their gates, in f32 -> (n_g * G, D)."""
    E, _, D = expert_out.shape
    n_rows = expert_out.shape[0] * expert_out.shape[1]
    weight = gates.transpose(1, 2).reshape(n_g, K * G) * keep  # 0 for a dropped pick
    picked = expert_out.reshape(n_rows, D)[dest.clamp(max=n_rows - 1)].float()
    y = (picked.view(n_g, K * G, D) * weight[..., None]).view(n_g, K, G, D).sum(1)
    return y.reshape(n_g * G, D)


def _moe_apply_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       group_size: Optional[int]) -> tuple[torch.Tensor, dict]:
    """:func:`moe_apply` on DTensors.  DTensor has no sharding strategy for
    the routing (sort, the capacity cumsum, the scatter into buckets), so
    each rank routes its own token rows (the batch shards of x; the router
    weight gathered), in groups of the size the whole batch would take
    where they divide its rows; the experts' input becomes a DTensor split
    by those rows, ``ops.moe_ffn`` runs it with the experts where the
    weights are (expert parallelism), and every expert's output for a
    rank's rows is gathered back to it for the combine.  The aux losses'
    means are partial sums over the row shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m, mesh = cfg.moe, x.device_mesh
    rows = [q if (q.is_shard() and q.dim == 0) else Replicate() for q in x.placements]
    split = [i for i, q in enumerate(rows) if q.is_shard()]
    xl = x.redistribute(mesh, rows).to_local(grad_placements=rows)
    B, S, D = x.shape
    Bl = xl.shape[0]
    T, Tl = B * S, Bl * S
    G = group_size or pick_group_size(T)
    if Tl % G:
        G = pick_group_size(Tl)
    n_g = Tl // G
    C = _capacity(G, m)
    partial = [Partial() if i in split else Replicate() for i in range(mesh.ndim)]
    router = {k: (v.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
                  grad_placements=partial) if is_dtensor(v) else v)
              for k, v in p["router"].items()}
    logits, probs, gates, e_pick, keep, dest, expert_in = _route(router, xl.reshape(Tl, D), m,
                                                                 n_g, G, C)
    by_rows = [Shard(1) if i in split else Replicate() for i in range(mesh.ndim)]
    expert_in = DTensor.from_local(expert_in, mesh, by_rows, run_check=False)
    expert_out = ops.moe_ffn(expert_in, p["w1"], p["w3"], p["w2"], act=cfg.act)
    expert_out = expert_out.redistribute(mesh, by_rows).to_local(grad_placements=by_rows)
    y = _combine(expert_out, gates, keep, dest, n_g, G, m.top_k).reshape(Bl, S, D).to(x.dtype)
    y = DTensor.from_local(y, mesh, rows, run_check=False)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg)

    E, n_groups = m.n_experts, T // G

    def mean(local_sum: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(local_sum, mesh, partial, run_check=False)

    kept = torch.zeros(n_g, E, dtype=xl.dtype, device=xl.device).scatter_add_(
        1, e_pick, keep.to(xl.dtype))
    me = mean(probs.sum(dim=(0, 1)) / (n_groups * G))
    ce = mean((kept / G).sum(dim=0).float() / n_groups)
    z = mean((torch.logsumexp(logits, dim=-1) ** 2).sum() / (n_groups * G))
    aux = {"moe_load_balance": E * torch.sum(me * ce) * m.router_aux_weight,
           "moe_z_loss": z * m.router_z_weight}
    return y, aux
