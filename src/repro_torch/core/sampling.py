"""Greedy MAP without the kernel seam (port of ``greedy_map_kdpp`` in
``repro/core/sampling.py``).

This is the kernel-free version the tests hold ``kernels.ops.
greedy_map_kdpp`` against, as the JAX tests do. The host samplers of the
JAX file (``sample_full_dpp``, ``sample_krondpp``) are not ported yet
(ROADMAP.md, queue 1 #3).
"""

from __future__ import annotations

import torch

from ..kernels.greedy_map import degeneracy_eps


def greedy_map_kdpp(L: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy MAP for a k-DPP: iteratively add the item of largest
    conditional variance (Chen et al. 2018 fast greedy, Cholesky-update
    form). O(N k²). Returns (k,) int32 picks on L's device.

    d tracks the conditional variance of every item; the columns of C
    build the Cholesky factor of L_Y over the chosen items. A degenerate
    pick (d_j at or below ``degeneracy_eps(L)``) clamps the divisor and
    zeroes its update, so later picks stay valid and finite.
    """
    k = int(k)
    N = int(L.shape[0])
    eps = degeneracy_eps(L)
    d = torch.diagonal(L)
    C = torch.zeros((N, k), dtype=L.dtype, device=L.device)
    chosen = torch.zeros((N,), dtype=torch.bool, device=L.device)
    picks = torch.empty((k,), dtype=torch.int64, device=L.device)
    for t in range(k):
        j = torch.argmax(torch.where(chosen, float("-inf"), d)).view(1)
        dj = d.index_select(0, j)
        ok = dj > eps
        e = (L.index_select(1, j).view(N) - C @ C.index_select(0, j).view(k)
             ) / torch.sqrt(torch.maximum(dj, eps))
        e = torch.where(ok, e, 0.0)
        d = torch.clamp_min(d - e * e, 0.0)
        C[:, t] = e
        chosen.index_fill_(0, j, True)
        picks[t:t + 1] = j
    return picks.to(torch.int32)
