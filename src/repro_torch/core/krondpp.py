"""KronDPP: a DPP whose kernel is L = L_1 ⊗ ... ⊗ L_m (port of
``repro/core/krondpp.py``). The full L is built only by ``full_matrix``,
for small-N references."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from .. import random as prng
from .._device import FLOAT, DeviceLike, resolve_device
from . import kron
from .dpp import SubsetBatch, identity_padded, masked_inv_and_logdet


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

    # -- index decomposition -----------------------------------------------
    def split_indices(self, idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Global index -> per-factor indices (row-major mixed radix)."""
        return kron.split_indices_multi(idx, self.sizes)

    def submatrix(self, idx: torch.Tensor) -> torch.Tensor:
        """L[idx, idx] for idx (..., k) -> (..., k, k), in O(k² m) without
        materializing L."""
        sub = None
        for f, p in zip(self.factors, self.split_indices(idx.long())):
            blk = f[p[..., :, None], p[..., None, :]]
            sub = blk if sub is None else sub * blk
        return sub

    # -- spectra -------------------------------------------------------------
    def eigh(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-factor eigendecompositions: O(sum N_i^3)."""
        return [tuple(torch.linalg.eigh(f)) for f in self.factors]

    def eigenvalues(self) -> torch.Tensor:
        """All N eigenvalues (row-major factor-index order)."""
        v = torch.linalg.eigvalsh(self.factors[0])
        for f in self.factors[1:]:
            v = torch.outer(v, torch.linalg.eigvalsh(f)).reshape(-1)
        return v

    def logdet_L_plus_I(self) -> torch.Tensor:
        """log det(I + L) = sum log(1 + prod_i d_i) — O(N), no O(N^3)."""
        return torch.log1p(self.eigenvalues()).sum()

    # -- likelihood ----------------------------------------------------------
    def log_likelihood(self, batch: SubsetBatch) -> torch.Tensor:
        """phi(L) over a padded subset batch."""
        sub = identity_padded(self.submatrix(batch.indices), batch.mask)
        _, lds = masked_inv_and_logdet(sub)
        return lds.mean() - self.logdet_L_plus_I()


def random_krondpp(key, sizes: Sequence[int], dtype: torch.dtype = FLOAT,
                   scale: float = 1.0, *, device: DeviceLike = "cuda"
                   ) -> KronDPP:
    """Paper Sec. 5.1 init: L_i = X^T X + 1e-3 I with X ~ U[0, sqrt(2)],
    times ``scale``, as factors of ``dtype`` — the JAX package's arguments
    in its order, ``device`` by keyword.

    ``key``: a PRNG key (``repro_torch.random``, or the JAX package's uint32
    key): per factor ``key, sub = split(key)``, X = uniform(sub, (s, s), 0,
    sqrt 2) * scale, so a key builds the JAX package's factors (up to the
    float32 roundoff of X^T X); X is drawn on ``device``. Or a
    ``torch.Generator``: X is drawn with ``torch.rand`` on the generator's
    device and moved to ``device``. X is a float32 draw either way (the
    JAX package runs with x64 off), cast to ``dtype``."""
    dev = resolve_device(device)
    keyed = not isinstance(key, torch.Generator)
    if keyed:
        key = prng.as_key(key, dev)
    factors = []
    for s in sizes:
        if keyed:
            key, sub = prng.split(key)
            X = prng.uniform(sub, (s, s), 0.0, math.sqrt(2.0)) * scale
        else:
            X = torch.rand((s, s), generator=key, dtype=FLOAT,
                           device=key.device) * math.sqrt(2.0)
            X = X.to(dev) * scale
        X = X.to(dtype)
        factors.append(X.T @ X + 1e-3 * torch.eye(s, dtype=dtype,
                                                  device=dev))
    return KronDPP(tuple(factors))
