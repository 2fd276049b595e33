"""Greedy MAP of a DPP (Chen, Zhang & Zhou, NeurIPS 2018, Alg. 1), plain:
step t picks the item of largest conditional variance d_i given the items
picked before it, d_i = L_ii - ‖c_i‖², where c_i holds the Cholesky rows
of the picked items.

``judge`` holds another implementation's picks to this definition along
the picks it made, in float64: at each step the gap is how far the picked
item's d lies below the best d of the step, as a share of that best.
``select`` is the plain loop itself, the control in a lower precision.
"""

from __future__ import annotations

import math

import torch

from .precision import matmul


def judge(L: torch.Tensor, picks: torch.Tensor) -> dict:
    """``gap``: the widest step gap of ``picks`` (k,) on L (N, N), taken in
    float64 (a repeated or out-of-range pick reads inf); ``steps``."""
    L = L.double()
    N = L.shape[0]
    picks = [int(j) for j in picks.tolist()]
    d = torch.diagonal(L).clone()
    CT = torch.zeros((len(picks), N), dtype=torch.float64, device=L.device)
    gaps = torch.zeros(len(picks), dtype=torch.float64, device=L.device)
    alive = torch.ones(N, dtype=torch.bool, device=L.device)
    for t, j in enumerate(picks):
        if not 0 <= j < N or not bool(alive[j]):
            return {"gap": float("inf"), "steps": t}
        best = torch.where(alive, d, torch.full_like(d, -float("inf"))).max()
        gaps[t] = (best - d[j]) / best.clamp_min(1e-300)
        e = (L[:, j] - CT[:t].T @ CT[:t, j]) / d[j].clamp_min(1e-300).sqrt()
        CT[t] = e
        d = d - e * e
        alive[j] = False
    return {"gap": float(gaps.max()) if picks else 0.0, "steps": len(picks)}


def select(L: torch.Tensor, k: int, precision: str = "exact"
           ) -> torch.Tensor:
    """(k,) greedy MAP picks of L (N, N) in L's dtype, every product at
    ``precision``."""
    N = L.shape[0]
    d = torch.diagonal(L).clone()
    CT = torch.zeros((k, N), dtype=L.dtype, device=L.device)
    picks = torch.zeros(k, dtype=torch.long, device=L.device)
    neg = torch.full_like(d, -math.inf)
    alive = torch.ones(N, dtype=torch.bool, device=L.device)
    for t in range(k):
        j = torch.argmax(torch.where(alive, d, neg))
        picks[t] = j
        dot = matmul(CT[:t].T, CT[:t, j][:, None], precision)[:, 0]
        e = (L[:, j] - dot) / d[j].clamp_min(1e-30).sqrt()
        CT[t] = e
        d = d - e * e
        alive[j] = False
    return picks
