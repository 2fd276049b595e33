"""A DeepSeek-V3 mixture-of-experts block (DeepSeek-AI, "DeepSeek-V3
Technical Report", arXiv:2412.19437, §2.1.2; ``modeling_deepseek.py`` of
the published checkpoints) and the unit kernels that DPP pruning of its
experts needs (Mariet & Sra, "Diversity Networks", ICLR 2016), plain.

    h     = x / sqrt(mean(x²) + eps) · scale                  (RMSNorm)
    s     = sigmoid(h W_r)                                    (E scores)
    c     = s + b                                             (for choice)
    group score = sum of a group's 2 best c; the topk_group best groups
    top_e = the K best c among their experts
    w     = s[top_e] / Σ s[top_e] (norm_topk_prob) · routed_scaling
    y     = x + Σ_k w_k FFN_{top_e,k}(h) + FFN_shared(h)
    FFN(h) = (silu(h W_gate) · (h W_up)) W_down

The unit kernel of an expert's units is L = ÂᵀÂ + 1e-4 I over the rows it
receives, each row's units a = w · silu(h W_gate) · (h W_up) (what reaches
the layer's output), Â = a / (‖a_col‖ + 1e-6); the shared experts' kernel
is the same over every row, weight 1. Computed in ``dtype`` with every
matrix product at ``precision`` (``precision.matmul``), rows in blocks:
G = Σ_blocks aᵀa, ‖a_col‖ = sqrt(G_jj), L = G / (n nᵀ) + 1e-4 I.

Departures from the published description, none of which changes a
result the benchmark compares:
- a group outside the ``topk_group`` best masks its experts with -inf;
  the published code fills 0.0, which differs only where a kept expert's
  biased score is below 0;
- ties of the biased score go to the lower expert index (a stable sort);
  the published code's ``torch.topk`` promises no order among ties;
- the weights' normalisation adds 1e-20 to the sum, as the published
  code does; the softmax scoring, for ``scoring_func`` "softmax", takes
  the top K of the softmax and normalises them (GShard-style, as the
  port's softmax routing), with no capacity;
- the norm of a column comes from the Gram matrix's diagonal, not from
  the activations themselves (the same quantity, another rounding).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import matmul

RIDGE = 1e-4
NORM_EPS = 1e-6


@dataclass(frozen=True)
class Routing:
    experts: int
    per_token: int
    scoring: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    scaling: float = 1.0

    @classmethod
    def of(cls, config: dict) -> "Routing":
        """From a published ``config.json``'s keys."""
        return cls(int(config["n_routed_experts"]),
                   int(config["num_experts_per_tok"]),
                   str(config["scoring_func"]), int(config["n_group"]),
                   int(config["topk_group"]),
                   bool(config["norm_topk_prob"]),
                   float(config["routed_scaling_factor"]))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype=torch.float64) -> torch.Tensor:
    x = x.to(dtype)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(dtype)


def route(h: torch.Tensor, router: torch.Tensor, bias: Optional[torch.Tensor],
          r: Routing, precision: str = "exact"):
    """(s (T, E), top_w (T, K), top_e (T, K) int64, margin (T,)) of the
    normed rows h (T, d) in h's dtype: margin is the K-th best biased score
    less the (K+1)-th (among the kept groups), how far the choice is from
    a tie."""
    logits = matmul(h, router.to(h.dtype), precision).to(h.dtype)
    if r.scoring == "softmax":
        s = torch.softmax(logits, dim=-1)
        choice = s
    else:
        s = torch.sigmoid(logits)
        choice = s + bias.to(h.dtype) if bias is not None else s
    if r.topk_group < r.n_group:
        grouped = choice.unflatten(-1, (r.n_group, -1))
        score = torch.sort(grouped, -1, descending=True).values[..., :2] \
            .sum(-1)
        keep = torch.sort(score, dim=-1, descending=True,
                          stable=True).indices[..., :r.topk_group]
        kept = torch.zeros_like(score, dtype=torch.bool).scatter_(-1, keep,
                                                                  True)
        choice = torch.where(kept[..., None], grouped,
                             -math.inf).flatten(-2)
    vals, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    K = r.per_token
    top_e = idx[:, :K]
    nxt = vals[:, K] if vals.shape[1] > K else \
        torch.full_like(vals[:, 0], -math.inf)
    return s, weights(s, top_e, r), top_e, vals[:, K - 1] - nxt


def weights(s: torch.Tensor, top_e: torch.Tensor, r: Routing
            ) -> torch.Tensor:
    """The routing weights (T, K) of the choice top_e from the scores s."""
    w = torch.gather(s, -1, top_e)
    if r.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + (1e-20 if r.scoring == "sigmoid"
                                            else 0.0))
    return w * r.scaling


def ffn_units(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              precision: str = "exact") -> torch.Tensor:
    dt = h.dtype
    return F.silu(matmul(h, w_gate.to(dt), precision).to(dt)) \
        * matmul(h, w_up.to(dt), precision).to(dt)


def moe_block(x: torch.Tensor, p: dict, r: Routing, eps: float,
              dtype=torch.float64, precision: str = "exact"
              ) -> torch.Tensor:
    """The block's output with its residual, x (T, d) -> (T, d), from
    weights ``p``: ``ln``, ``router``, ``router_bias`` (optional),
    ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and, with shared
    experts, ``shared_gate``/``shared_up`` (d, fs), ``shared_down``
    (fs, d). Each expert runs on the rows routed to it, none dropped."""
    h = rms_norm(x, p["ln"], eps, dtype)
    _, top_w, top_e, _ = route(h, p["router"], p.get("router_bias"), r,
                               precision)
    y = torch.zeros_like(h)
    for e in range(r.experts):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            a = ffn_units(h[tok], p["w_gate"][e], p["w_up"][e], precision)
            out = matmul(a, p["w_down"][e].to(dtype), precision).to(dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if "shared_gate" in p:
        a = ffn_units(h, p["shared_gate"], p["shared_up"], precision)
        y = y + matmul(a, p["shared_down"].to(dtype), precision).to(dtype)
    return x.to(dtype) + y


def _gram_kernel(blocks: Iterator[torch.Tensor], f: int, dtype,
                 device, precision: str) -> torch.Tensor:
    G = torch.zeros((f, f), dtype=dtype, device=device)
    for a in blocks:
        G += matmul(a.T, a, precision).to(dtype)
    n = torch.sqrt(torch.clamp_min(torch.diagonal(G), 0.0)) + NORM_EPS
    L = G / (n[:, None] * n[None, :])
    L.diagonal().add_(RIDGE)
    return L


def expert_unit_kernels(x: torch.Tensor, p: dict, r: Routing, eps: float,
                        top_e: Optional[torch.Tensor] = None,
                        dtype=torch.float64, precision: str = "exact",
                        block: int = 8192
                        ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(expert, its unit kernel (f, f)) for each routed expert in turn.
    The rows each expert receives are the reference's own choice, or
    those of ``top_e`` (T, K) when given; their weights come from the
    reference's scores either way."""
    h = rms_norm(x, p["ln"], eps, dtype)
    s, top_w, own, _ = route(h, p["router"], p.get("router_bias"), r,
                             precision)
    if top_e is None:
        top_e = own
    else:
        top_e = top_e.to(device=h.device, dtype=torch.int64)
        top_w = weights(s, top_e, r)
    f = p["w_gate"].shape[-1]
    for e in range(r.experts):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)

        def blocks():
            for b in range(0, tok.numel(), block):
                t, k = tok[b:b + block], slot[b:b + block]
                yield ffn_units(h[t], p["w_gate"][e], p["w_up"][e],
                                precision) * top_w[t, k][:, None]
        yield e, _gram_kernel(blocks(), f, dtype, h.device, precision)


def shared_unit_kernel(x: torch.Tensor, p: dict, eps: float,
                       dtype=torch.float64, precision: str = "exact",
                       block: int = 8192) -> torch.Tensor:
    """The shared experts' unit kernel (fs, fs) over every row."""
    h = rms_norm(x, p["ln"], eps, dtype)

    def blocks():
        for b in range(0, h.shape[0], block):
            yield ffn_units(h[b:b + block], p["shared_gate"],
                            p["shared_up"], precision)
    return _gram_kernel(blocks(), p["shared_gate"].shape[-1], dtype,
                        h.device, precision)


def judge(L: torch.Tensor, picks: torch.Tensor, rank: int) -> dict:
    """Greedy MAP's picks (k,) on L (N, N) held to the definition along
    their order, in float64 (``greedy_map.judge``'s walk), with one rule
    for ties: the data part of a unit kernel built on n rows has rank at
    most n, so from step ``rank`` = n on every conditional variance left
    is the ridge's alone (a function of the 1e-4 ridge and of the picks
    made, formed by cancelling terms of order 1: no float32 computation
    resolves one from another). Any live pick there is as good as another
    and its gap is not counted. ``gap``: the widest counted step gap (a
    repeated or out-of-range pick reads inf at any step); ``ties``: the
    steps not counted."""
    L = L.double()
    N = L.shape[0]
    picks = [int(j) for j in picks.tolist()]
    if len(set(picks)) < len(picks) or not all(0 <= j < N for j in picks):
        return {"gap": math.inf, "ties": 0}
    d = torch.diagonal(L).clone()
    CT = torch.zeros((len(picks), N), dtype=torch.float64, device=L.device)
    gaps = torch.zeros(len(picks), dtype=torch.float64, device=L.device)
    alive = torch.ones(N, dtype=torch.bool, device=L.device)
    for t, j in enumerate(picks):
        best = torch.where(alive, d, torch.full_like(d, -math.inf)).max()
        gaps[t] = (best - d[j]) / best.clamp_min(1e-300)
        e = (L[:, j] - CT[:t].T @ CT[:t, j]) / d[j].clamp_min(1e-300).sqrt()
        CT[t] = e
        d = d - e * e
        alive[j] = False
    counted = min(len(picks), int(rank))
    gap = float(gaps[:counted].max()) if counted else 0.0
    return {"gap": gap, "ties": len(picks) - counted}
