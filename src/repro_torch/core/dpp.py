"""Subset batches and the marginal-kernel oracle (port of
``repro/core/dpp.py``: ``SubsetBatch`` and ``marginal_kernel``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass
class SubsetBatch:
    """n observed subsets, padded to k_max items.

    indices: (n, k_max) int32 — ground-set indices, 0 in padded slots.
    mask:    (n, k_max) bool  — True for real items.
    truncated: optional (n,) bool provenance from the device samplers —
        True for rows whose draw overflowed the sampler's static k_max
        budget and was clipped (``compact_selection``). None for batches
        that cannot truncate (observed data).
    """
    indices: torch.Tensor
    mask: torch.Tensor
    truncated: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return int(self.indices.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.indices.shape[1])

    def sizes(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def truncation_count(self) -> int:
        """Rows clipped at the sampler's k_max budget (0 when provenance
        is absent)."""
        return 0 if self.truncated is None else int(self.truncated.sum())

    @staticmethod
    def from_lists(subsets: Sequence[Sequence[int]],
                   k_max: Optional[int] = None,
                   device: DeviceLike = "cuda") -> "SubsetBatch":
        dev = resolve_device(device)
        k_max = k_max or max(len(s) for s in subsets)
        n = len(subsets)
        idx = np.zeros((n, k_max), np.int32)
        mask = np.zeros((n, k_max), bool)
        for i, s in enumerate(subsets):
            s = list(s)
            idx[i, : len(s)] = s
            mask[i, : len(s)] = True
        return SubsetBatch(torch.from_numpy(idx).to(dev),
                           torch.from_numpy(mask).to(dev))

    def to_lists(self) -> List[List[int]]:
        idx = self.indices.cpu().numpy()
        msk = self.mask.cpu().numpy()
        return [idx[i][msk[i]].tolist() for i in range(self.n)]


def marginal_kernel(L: np.ndarray) -> np.ndarray:
    """K = L (L + I)^{-1} — the numpy oracle."""
    N = L.shape[0]
    return L @ np.linalg.inv(L + np.eye(N))
