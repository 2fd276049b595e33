"""Full-kernel Picard iteration (Mariet & Sra 2015, paper ref [25]) — the
O(N^3)/iteration baseline KrK-Picard is compared against (port of
``repro/core/picard.py``).

    L <- L + a * L Δ L,   Δ = (1/n) Σ_i U_i L_{Y_i}^{-1} U_i^T - (L+I)^{-1}
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import torch

from .._device import DeviceLike, as_float, resolve_device
from .dpp import SubsetBatch, log_likelihood, picard_delta


def picard_step(L: torch.Tensor, batch: SubsetBatch, a: float = 1.0
                ) -> torch.Tensor:
    """One Picard update of the dense kernel, symmetrized, where ``L``
    lives."""
    delta = picard_delta(L, batch)
    L_new = L + a * (L @ delta @ L)
    return 0.5 * (L_new + L_new.T)


@dataclasses.dataclass
class PicardResult:
    L: torch.Tensor
    log_likelihoods: List[float]
    step_times: List[float]


def fit_picard(L, batch: SubsetBatch, iters: int = 10, a: float = 1.0,
               track_ll: bool = True, device: DeviceLike = "cuda"
               ) -> PicardResult:
    """``iters`` Picard steps from ``L`` (a tensor or array, placed on
    ``device`` as float32; the batch is moved there). ``step_times`` are
    host-clock seconds per step, each ending in a device sync;
    ``log_likelihoods`` holds the initial LL and one after each step."""
    dev = resolve_device(device)
    L = as_float(L, dev)
    batch = SubsetBatch(batch.indices.to(dev), batch.mask.to(dev))
    lls, times = [], []
    if track_ll:
        lls.append(float(log_likelihood(L, batch)))
    for _ in range(iters):
        t0 = time.perf_counter()
        L = picard_step(L, batch, a)
        if L.is_cuda:
            torch.cuda.synchronize(L.device)
        times.append(time.perf_counter() - t0)
        if track_ll:
            lls.append(float(log_likelihood(L, batch)))
    return PicardResult(L, lls, times)
