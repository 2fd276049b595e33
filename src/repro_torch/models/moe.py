"""Mixture-of-Experts FFN with per-group sort-based dispatch (dropping,
GShard capacity discipline; port of ``repro/models/moe.py``) — no dense
one-hot dispatch einsum, so expert FLOPs stay at
``tokens × top_k × 3·d·d_ff × 2 × capacity_factor``.

A group is a batch row. Within a group the (token, k) pairs are sorted by
expert with a stable sort, each pair's rank within its expert's run is its
slot, and a pair past the capacity C goes to the sentinel row E·C, which
is cut off; the experts' FFNs are einsums over (B, E, C, d) × (E, d, f),
as in the JAX package (whose expert products are XLA einsums, not a
Pallas kernel). Sharded, a DTensor layer input runs on local shards
(``distributed.shard_ops.experts_local``): the routing and the dispatch
on each data shard's rows, the experts' einsums on each model rank's
expert shard (EP) or, where the experts do not divide "model", on its
shard of the ffn-hidden dim (mixtral's 8 experts on a larger model
axis), the outputs summed over "model". ``moe_aux_loss`` takes DTensors
as they are (its means reduce over the batch shards).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from .. import random as prng
from ..config import ModelConfig
from ..distributed.constraints import constrain
from ..distributed.shard_ops import experts_local
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


def _moe_y(p, x: torch.Tensor, cfg: ModelConfig, e0: int = 0,
           n_local: int = 0) -> torch.Tensor:
    """The MoE FFN's output (without the residual) of x (B, S, d), from
    the experts e0 .. e0 + n_local - 1 (all of them for n_local 0) whose
    weights ``p`` holds; ``p``'s weights may hold a shard of each
    expert's ffn-hidden dim, giving that shard's share of the output."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    n_local = n_local or E
    C = group_capacity(S, cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    _, top_w, top_e = route(p, h, cfg)
    dest = slot_map(top_e, E, C)                              # (B, S*K)
    if n_local != E:
        # this rank's experts: slots of the others go to its sentinel
        rel = dest - e0 * C
        dest = torch.where((rel >= 0) & (rel < n_local * C), rel,
                           n_local * C)

    # dispatch: each pair's token row into its slot of (B, E*C + 1, d);
    # only the sentinel row can take two writes, and it is cut off
    src = h.repeat_interleave(K, dim=1)                       # (B, S*K, d)
    idx = dest[..., None].expand(B, S * K, d)
    buf = torch.zeros((B, n_local * C + 1, d), dtype=h.dtype,
                      device=h.device).scatter(1, idx, src)
    buf = constrain(buf[:, :n_local * C].reshape(B, n_local, C, d),
                    "batch", "model", None, None)

    gate = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", swiglu(gate, up), p["w_down"])
    out = constrain(out, "batch", "model", None, None)

    # undispatch: gather each pair's row (a dropped pair reads the zero
    # sentinel), weight it, and sum a token's K pairs. The K pairs of a
    # token are adjacent, so the reference's segment_sum over
    # repeat(arange(S), K) is a sum over a (S, K) reshape: no atomics, the
    # same bits from run to run on the card.
    out = torch.cat([out.reshape(B, n_local * C, d),
                     torch.zeros((B, 1, d), dtype=out.dtype,
                                 device=out.device)], dim=1)
    y = torch.gather(out, 1, idx) * top_w.reshape(B, S * K, 1).to(out.dtype)
    return y.reshape(B, S, K, d).sum(2)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Groups = batch rows. A DTensor ``x`` (or
    DTensor weights) runs on local shards
    (``distributed.shard_ops.experts_local``)."""
    if isinstance(x, DTensor) or isinstance(p["w_gate"], DTensor):
        return experts_local(
            lambda xl, pl, e0, n: _moe_y(pl, xl, cfg, e0, n), p, x)
    return x + _moe_y(p, x, cfg).to(x.dtype)


def moe_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    probs, _, top_e = route(p, h, cfg)
    experts = torch.arange(cfg.n_experts, device=top_e.device)
    hard = (top_e[..., None] == experts).sum(-2)              # (B, S, E)
    f = hard.float().mean((0, 1)) / cfg.experts_per_token
    pbar = probs.mean((0, 1))
    return cfg.n_experts * torch.sum(f * pbar)
