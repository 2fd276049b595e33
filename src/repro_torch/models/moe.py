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

DeepSeek-V3's block (``router_scoring="sigmoid"``) routes by sigmoid
scores with a correction bias used for selection only, within the best
groups of experts, and adds shared experts (one MLP of
``n_shared_experts · d_ff`` units that every token runs). Shared experts
run on unsharded inputs only. ``dispatch_dropless`` gives every routed
(token, slot) pair to its expert, with no capacity, for callers that must
see every token an expert receives (``models.prune``).
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
    fs = cfg.n_shared_experts * f
    ks = prng.split(key, 7 if fs else 4)
    p = {
        "router": dense_init(ks[..., 0, :], (d, E), torch.float32),
        "w_gate": dense_init(ks[..., 1, :], (E, d, f), dtype, fan_in=d),
        "w_up": dense_init(ks[..., 2, :], (E, d, f), dtype, fan_in=d),
        "w_down": dense_init(ks[..., 3, :], (E, f, d), dtype, fan_in=f),
        "ln": torch.ones(tuple(ks.shape[:-2]) + (d,), dtype=dtype,
                         device=ks.device),
    }
    if cfg.router_scoring == "sigmoid":
        # the correction bias: DeepSeek-V3 starts it at 0 and moves it by
        # its load-balancing rule, not by gradients
        p["router_bias"] = torch.zeros(tuple(ks.shape[:-2]) + (E,),
                                       dtype=torch.float32, device=ks.device)
    if fs:
        p["shared_gate"] = dense_init(ks[..., 4, :], (d, fs), dtype)
        p["shared_up"] = dense_init(ks[..., 5, :], (d, fs), dtype)
        p["shared_down"] = dense_init(ks[..., 6, :], (fs, d), dtype)
    return p


def group_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    cap = math.ceil(tokens_per_group * cfg.experts_per_token
                    * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 1)


def route(p, h: torch.Tensor, cfg: ModelConfig):
    """(probs (..., E), top_w (..., K), top_e (..., K)) of h (..., d).

    Softmax scoring: the K most probable experts, their probabilities
    normalised. JAX promotes ``h.astype(f32) @ router`` to float32 whatever
    the router's dtype (a bfloat16 router under bfloat16 compute); a torch
    product does not promote, so the router is upcast (exactly).
    ``lax.top_k`` takes the lower index first among equal probabilities;
    ``torch.topk`` promises no order among ties. A stable descending sort
    keeps equal values in index order, so its first K columns are
    ``lax.top_k``'s choice, ties included.

    Sigmoid scoring (DeepSeek-V3, ``topk_method`` noaux_tc): s =
    sigmoid(h·W_r); the choice is made on s + bias (``p["router_bias"]``,
    where p holds one): a group's score is the sum of its 2 best biased scores, the
    ``topk_group`` best groups are kept, and the K best biased scores
    among their experts are taken, ties to the lower index as above. The
    weights are the unbiased s of the K, normalised when
    ``norm_topk_prob`` is set. Both times ``routed_scaling``; ``probs`` is
    s."""
    logits = h.float() @ p["router"].float()
    K = cfg.experts_per_token
    if cfg.router_scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_w, top_e = top_w[..., :K], top_e[..., :K]
        if cfg.norm_topk_prob:
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                            1e-9)
    elif cfg.router_scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        choice = probs + p["router_bias"].float() if "router_bias" in p \
            else probs
        if cfg.topk_group < cfg.n_group:
            grouped = choice.unflatten(-1, (cfg.n_group, -1))
            best2 = torch.sort(grouped, dim=-1, descending=True).values
            score = best2[..., :2].sum(-1)
            keep = torch.sort(score, dim=-1, descending=True,
                              stable=True).indices[..., :cfg.topk_group]
            kept = torch.zeros_like(score, dtype=torch.bool).scatter_(
                -1, keep, True)
            choice = torch.where(kept[..., None], grouped,
                                 float("-inf")).flatten(-2)
        top_e = torch.sort(choice, dim=-1, descending=True,
                           stable=True).indices[..., :K]
        top_w = torch.gather(probs, -1, top_e)
        if cfg.norm_topk_prob:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    else:
        raise ValueError(f"router_scoring must be 'softmax' or 'sigmoid', "
                         f"got {cfg.router_scoring!r}")
    if cfg.routed_scaling != 1.0:
        top_w = top_w * cfg.routed_scaling
    return probs, top_w, top_e


def dispatch_dropless(top_e: torch.Tensor, n_experts: int):
    """Every routed (token, slot) pair of top_e (T, K), grouped by expert:
    (order (T·K,) int64, the pairs t·K + k in expert order and, within an
    expert, in (token, slot) order (a stable sort); counts (E,) int64, the
    pairs each expert receives). No capacity: nothing is dropped."""
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    return order, counts


def shared_mlp(p, h: torch.Tensor) -> torch.Tensor:
    """The shared experts' output (without the residual) of the normed
    h: one SwiGLU MLP of ``n_shared_experts · d_ff`` units."""
    return swiglu(h @ p["shared_gate"], h @ p["shared_up"]) \
        @ p["shared_down"]


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


def _moe_y(p, h: torch.Tensor, cfg: ModelConfig, e0: int = 0,
           n_local: int = 0) -> torch.Tensor:
    """The MoE FFN's output (without the residual) of the normed h
    (B, S, d), from
    the experts e0 .. e0 + n_local - 1 (all of them for n_local 0) whose
    weights ``p`` holds; ``p``'s weights may hold a shard of each
    expert's ffn-hidden dim, giving that shard's share of the output."""
    B, S, d = h.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    n_local = n_local or E
    C = group_capacity(S, cfg)
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
        if cfg.n_shared_experts:
            raise NotImplementedError("moe_ffn: shared experts run on "
                                      "unsharded inputs only")
        return experts_local(lambda xl, pl, e0, n: _moe_y(
            pl, rms_norm(xl, pl["ln"], cfg.norm_eps), cfg, e0, n), p, x)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y = _moe_y(p, h, cfg)
    if cfg.n_shared_experts:
        y = y + shared_mlp(p, h)
    return x + y.to(x.dtype)


def moe_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    probs, _, top_e = route(p, h, cfg)
    experts = torch.arange(cfg.n_experts, device=top_e.device)
    hard = (top_e[..., None] == experts).sum(-2)              # (B, S, E)
    f = hard.float().mean((0, 1)) / cfg.experts_per_token
    pbar = probs.mean((0, 1))
    return cfg.n_experts * torch.sum(f * pbar)
