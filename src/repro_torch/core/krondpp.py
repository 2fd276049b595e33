"""KronDPP: a DPP whose kernel is L = L_1 ⊗ ... ⊗ L_m (port of
``repro/core/krondpp.py``). The full L is built only by ``full_matrix``,
for small-N references."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from .._device import FLOAT, DeviceLike, resolve_device


@dataclasses.dataclass
class KronDPP:
    """m-factor Kronecker DPP. Factors are PD float32 matrices."""
    factors: Tuple[torch.Tensor, ...]

    @property
    def m(self) -> int:
        return len(self.factors)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(f.shape[0]) for f in self.factors)

    @property
    def N(self) -> int:
        return math.prod(self.sizes)

    def full_matrix(self) -> torch.Tensor:
        """Reference only — O(N^2) memory."""
        L = self.factors[0]
        for f in self.factors[1:]:
            L = torch.kron(L, f)
        return L


def random_krondpp(generator: torch.Generator, sizes: Sequence[int],
                   device: DeviceLike = "cuda") -> KronDPP:
    """Paper Sec. 5.1 init: L_i = X^T X + 1e-3 I with X ~ U[0, sqrt(2)].

    X is drawn on the generator's device and the factors are moved to
    ``device``."""
    dev = resolve_device(device)
    factors = []
    for s in sizes:
        X = torch.rand((s, s), generator=generator, dtype=FLOAT,
                       device=generator.device) * math.sqrt(2.0)
        X = X.to(dev)
        factors.append(X.T @ X + 1e-3 * torch.eye(s, dtype=FLOAT,
                                                  device=dev))
    return KronDPP(tuple(factors))
