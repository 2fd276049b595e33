"""Mixture-of-Experts FFN with per-group sort-based dispatch (dropping,
GShard capacity discipline; port of ``repro/models/moe.py``) — no dense
one-hot dispatch einsum, so expert FLOPs stay at
``tokens × top_k × 3·d·d_ff × 2 × capacity_factor``.

A group is a batch row. Within a group the (token, k) pairs are sorted by
expert with a stable sort, each pair's rank within its expert's run is its
slot, and a pair past the capacity C goes to the sentinel row E·C, which
is cut off; the experts' FFNs are einsums over (B, E, C, d) × (E, d, f),
as in the JAX package (whose expert products are XLA einsums, not a
Pallas kernel). The reference's sharding hints (``constrain``) do nothing
on one card and have no counterpart here.
"""

from __future__ import annotations

import math

import torch

from .. import random as prng
from ..config import ModelConfig
from .common import dense_init, rms_norm, swiglu


def init_moe_params(key, cfg: ModelConfig, dtype: torch.dtype):
    """One layer's MoE weights from a key (..., 2); a batch of keys stacks
    them. The router is float32 whatever ``dtype``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ks = prng.split(key, 4)
    return {
        "router": dense_init(ks[..., 0, :], (d, E), torch.float32),
        "w_gate": dense_init(ks[..., 1, :], (E, d, f), dtype, fan_in=d),
        "w_up": dense_init(ks[..., 2, :], (E, d, f), dtype, fan_in=d),
        "w_down": dense_init(ks[..., 3, :], (E, f, d), dtype, fan_in=f),
        "ln": torch.ones(tuple(ks.shape[:-2]) + (d,), dtype=dtype,
                         device=ks.device),
    }


def group_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    cap = math.ceil(tokens_per_group * cfg.experts_per_token
                    * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 1)


def route(p, h: torch.Tensor, cfg: ModelConfig):
    """(probs (B, S, E), top_w (B, S, K) normalised, top_e (B, S, K)).

    JAX promotes ``h.astype(f32) @ router`` to float32 whatever the
    router's dtype (a bfloat16 router under bfloat16 compute); a torch
    product does not promote, so the router is upcast (exactly).
    ``lax.top_k`` takes the lower index first among equal probabilities;
    ``torch.topk`` promises no order among ties. A stable descending sort
    keeps equal values in index order, so its first K columns are
    ``lax.top_k``'s choice, ties included."""
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def slot_map(top_e: torch.Tensor, n_experts: int, capacity: int
             ) -> torch.Tensor:
    """The slot of every (token, k) pair of each group, (B, S·K) int64:
    expert · C + its rank within the expert, or the sentinel E·C when the
    rank reaches C. Pairs are ranked in (token, k) order within an expert
    (a stable sort, as ``jnp.argsort``)."""
    B = top_e.shape[0]
    flat_e = top_e.reshape(B, -1)
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=top_e.device)
    starts = torch.searchsorted(sorted_e, experts.expand(B, n_experts)
                                .contiguous(), side="left")
    rank = torch.arange(n, device=top_e.device) - torch.gather(
        starts, 1, sorted_e)
    dest = torch.where(rank < capacity, sorted_e * capacity + rank,
                       n_experts * capacity)
    # invert the sort: pair order[j] takes dest[j]
    return torch.empty_like(dest).scatter_(1, order, dest)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Groups = batch rows."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = group_capacity(S, cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    _, top_w, top_e = route(p, h, cfg)
    dest = slot_map(top_e, E, C)                              # (B, S*K)

    # dispatch: each pair's token row into its slot of (B, E*C + 1, d);
    # only the sentinel row can take two writes, and it is cut off
    src = h.repeat_interleave(K, dim=1)                       # (B, S*K, d)
    idx = dest[..., None].expand(B, S * K, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=h.dtype, device=h.device
                      ).scatter(1, idx, src)
    buf = buf[:, :E * C].reshape(B, E, C, d)

    gate = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", swiglu(gate, up), p["w_down"])

    # undispatch: gather each pair's row (a dropped pair reads the zero
    # sentinel), weight it, and sum a token's K pairs. The K pairs of a
    # token are adjacent, so the reference's segment_sum over
    # repeat(arange(S), K) is a sum over a (S, K) reshape: no atomics, the
    # same bits from run to run on the card.
    out = torch.cat([out.reshape(B, E * C, d),
                     torch.zeros((B, 1, d), dtype=out.dtype,
                                 device=out.device)], dim=1)
    y = torch.gather(out, 1, idx) * top_w.reshape(B, S * K, 1).to(out.dtype)
    y = y.reshape(B, S, K, d).sum(2)
    return x + y.to(x.dtype)


def moe_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    probs, _, top_e = route(p, h, cfg)
    hard = torch.nn.functional.one_hot(top_e, cfg.n_experts).sum(-2)
    f = hard.float().mean((0, 1)) / cfg.experts_per_token
    pbar = probs.mean((0, 1))
    return cfg.n_experts * torch.sum(f * pbar)
