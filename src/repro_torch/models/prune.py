"""DPP pruning of a mixture-of-experts layer's units (Diversity Networks,
Mariet & Sra, ICLR 2016, arXiv:1511.05077), every expert at once.

For a probe batch x of positions entering the layer:

    h     = RMSNorm(x)                               (the layer's norm)
    top_w, top_e = route(h)                          (``moe.route``)
    a_e   = w · silu(h W_gate[e]) · (h W_up[e])      (each row routed to e,
                                                      scaled by its weight)
    a_s   = silu(h W_sg) · (h W_su)                  (the shared experts,
                                                      every row)
    L     = ÂᵀÂ + 1e-4 I, Â = a / (‖a_col‖ + 1e-6)   (one unit kernel an
                                                      expert, one shared)


then greedy MAP keeps ``keep_fraction`` of each expert's units: one
``greedy_map_kdpp`` call on the (E, f, f) batch of routed kernels and one
on the shared kernel. The routed rows are those ``dispatch_dropless``
gives each expert: no capacity, so each kernel sees every token its expert
receives. The expert products run grouped, one pair of products an expert
over exactly its rows (no padding). Everything is float32; the products
follow ``torch.backends.cuda.matmul.allow_tf32`` (off by default).
"""

from __future__ import annotations

import torch

from .. import obs
from ..config import ModelConfig
from ..dpp import functional as dpp_functional
from . import moe
from .common import rms_norm, swiglu

#: The ridge of every unit kernel, and the guard of the column norms.
RIDGE = 1e-4
NORM_EPS = 1e-6


def unit_kernel(A: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """L = ÂᵀÂ + 1e-4 I of the units' activations A (n, f) into ``out``
    (f, f); a unit with no activation (n = 0 or an all-zero column) keeps
    only the ridge."""
    if A.shape[0]:
        An = A / (torch.linalg.norm(A, dim=0, keepdim=True) + NORM_EPS)
        torch.mm(An.T, An, out=out)
    else:
        out.zero_()
    out.diagonal().add_(RIDGE)
    return out


def prune_moe_layer(p, x: torch.Tensor, cfg: ModelConfig,
                    keep_fraction: float) -> dict:
    """Choose the units to keep of every expert of one MoE layer of
    weights ``p`` (``moe.init_moe_params``'s leaves: ``ln``, ``router``,
    ``router_bias`` where the routing has one, ``w_gate``/``w_up`` (E, d,
    f), ``shared_gate``/``shared_up`` (d, n_shared·f)) from the probe x
    (..., d). Returns, on x's device:

    - ``routed``: (E, int(f · keep_fraction)) int32 picks of each expert,
      in the order greedy MAP took them;
    - ``shared``: (int(n_shared·f · keep_fraction),) int32 picks of the
      shared experts' units (absent without shared experts);
    - ``tokens_per_expert``: (E,) int64 routed rows of each expert;
    - ``top_e``: (T, K) the experts each probe position was routed to;
    - ``rows_computed``: the expert-product rows run (an int); T·K in
      this grouped layout, which pads nothing.
    """
    E, K, f = cfg.n_experts, cfg.experts_per_token, cfg.d_ff
    with obs.spans.start_span("moe.route"):
        h = rms_norm(x.reshape(-1, x.shape[-1]).float(), p["ln"],
                     cfg.norm_eps)
        _, top_w, top_e = moe.route(p, h, cfg)
        order, counts = moe.dispatch_dropless(top_e, E)
        sizes = counts.tolist()
    with obs.spans.start_span("prune.expert_acts"):
        rows = h.index_select(0, order // K)
        weight = top_w.reshape(-1).index_select(0, order)[:, None]
        A = torch.empty((rows.shape[0], f), dtype=torch.float32,
                        device=h.device)
        start = 0
        for e, n in enumerate(sizes):
            if n:
                r = rows[start:start + n]
                torch.mul(swiglu(r @ p["w_gate"][e], r @ p["w_up"][e]),
                          weight[start:start + n], out=A[start:start + n])
            start += n
        del rows
        A_shared = swiglu(h @ p["shared_gate"], h @ p["shared_up"]) \
            if cfg.n_shared_experts else None
    with obs.spans.start_span("prune.unit_kernels"):
        L = torch.empty((E, f, f), dtype=torch.float32, device=h.device)
        for e, rows_e in enumerate(torch.split(A, sizes)):
            unit_kernel(rows_e, L[e])
        del A
        if A_shared is not None:
            fs = A_shared.shape[1]
            L_shared = unit_kernel(A_shared, torch.empty(
                (fs, fs), dtype=torch.float32, device=h.device))
            del A_shared
    out = {"tokens_per_expert": counts, "top_e": top_e,
           "rows_computed": int(sum(sizes))}
    with obs.spans.start_span("prune.map"):
        out["routed"] = dpp_functional.greedy_map_kdpp(
            L, int(f * keep_fraction))
        if cfg.n_shared_experts:
            out["shared"] = dpp_functional.greedy_map_kdpp(
                L_shared, int(L_shared.shape[0] * keep_fraction))
    return out
