"""Dual spectrum of a low-rank kernel L = φφᵀ, φ = V·√q (port of
``repro/lowrank/dual.py``).

The r×r dual Gram C = φᵀφ shares its nonzero eigenvalues with the N×N
kernel L (Kulesza & Taskar §3.3): if (d, w) is an eigenpair of C with
d > 0 then u = φw/√d is a unit eigenvector of L with the same eigenvalue,
det(I_N + L) = det(I_r + C), and the marginal kernel is
K = φ (C + I)⁻¹ φᵀ. ``DualSpectrum`` packages that factorization with the
size/budget protocol of ``FactorSpectrum`` (``device``, ``to``,
``expected_size``, ``suggested_k_max``), so the facade and
``SamplingService`` consume it unchanged, plus the
``sample_rows``/``sample_rows_kdpp`` hooks the batched samplers dispatch
through (duck-typed, so ``repro_torch.sampling`` never imports this
package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DualSpectrum:
    """Eigendecomposition of the rank-r dual Gram C = Vᵀ diag(q) V.

    phi:  (N, r) feature rows φ = V·√q (so L = φφᵀ).
    lams: (r,) dual eigenvalues, clipped to >= 0, ascending: the nonzero
          eigenvalues of L.
    W:    (r, r) orthonormal dual eigenvectors (columns).
    """
    phi: torch.Tensor
    lams: torch.Tensor
    W: torch.Tensor

    @property
    def N(self) -> int:
        return int(self.phi.shape[0])

    @property
    def rank(self) -> int:
        return int(self.phi.shape[1])

    @property
    def device(self) -> torch.device:
        return self.phi.device

    def to(self, device: DeviceLike) -> "DualSpectrum":
        dev = resolve_device(device)
        return DualSpectrum(self.phi.to(dev), self.lams.to(dev),
                            self.W.to(dev))

    def log_eigenvalues(self) -> torch.Tensor:
        """log of the r dual eigenvalues (-inf for zeros). The kernel's
        other N - r eigenvalues are exactly zero and add nothing to
        inclusion probabilities, sizes or gains."""
        return torch.log(self.lams)

    def basis(self) -> torch.Tensor:
        """E = W·diag(d^{-1/2}) (r, r): column j maps the dual eigenvector
        w_j to the coefficients of L's eigenvector u_j = φ E[:, j].
        Zero-eigenvalue columns are zeroed (phase 1 selects them with
        probability 0; the guard only suppresses inf·0 NaNs)."""
        pos = self.lams > 0.0
        inv = torch.where(pos, self.lams, torch.ones_like(self.lams)) ** -0.5
        return self.W * torch.where(pos, inv, torch.zeros_like(inv))[None, :]

    def expected_size(self) -> float:
        """E|Y| = Σ d/(1+d) = Σ σ(log d) over the r dual eigenvalues."""
        return float(torch.sigmoid(self.log_eigenvalues()).sum())

    def size_std(self) -> float:
        ll = self.log_eigenvalues()
        p = torch.sigmoid(ll)
        return float(torch.sqrt(torch.sum(p * torch.sigmoid(-ll))))

    def suggested_k_max(self, num_std: float = 6.0) -> int:
        """Static phase-2 budget: E|Y| + num_std·σ, clamped to [1, rank]
        (a low-rank draw never exceeds r items)."""
        k = math.ceil(self.expected_size() + num_std * self.size_std()) + 1
        return max(1, min(k, self.rank))

    # -- sampler dispatch hooks --------------------------------------------
    # ``sample_krondpp_batched`` / ``_keyed`` / ``sample_kdpp_batched`` call
    # these instead of gathering N-dimensional eigenvectors.
    def sample_rows(self, row_keys, k_max: int,
                    backend: Optional[str] = None,
                    num_samples: Optional[int] = None, runtime=None):
        """DPP rows from per-row keys (B, 2), or ``num_samples`` rows from
        a ``torch.Generator``: (picks, counts, truncated). A ``Mesh``
        ``runtime`` shards the keys (``sample.sample_dual_keyed``) and
        refuses a generator."""
        from ..sampling.batched import refuse_generator_on_mesh
        from .sample import sample_dual_generator, sample_dual_keyed
        if isinstance(row_keys, torch.Generator):
            refuse_generator_on_mesh(runtime)
            return sample_dual_generator(row_keys, self, int(k_max),
                                         int(num_samples), backend=backend)
        return sample_dual_keyed(row_keys, self, int(k_max), backend=backend,
                                 runtime=runtime)

    def sample_rows_kdpp(self, row_keys, k: int,
                         backend: Optional[str] = None,
                         num_samples: Optional[int] = None,
                         runtime=None) -> torch.Tensor:
        """k-DPP rows from per-row keys (B, 2), or ``num_samples`` rows
        from a ``torch.Generator``: (B, k) picks; ``runtime`` as in
        ``sample_rows``."""
        from ..sampling.batched import refuse_generator_on_mesh
        from .sample import (sample_dual_kdpp_generator,
                             sample_dual_kdpp_keyed)
        if isinstance(row_keys, torch.Generator):
            refuse_generator_on_mesh(runtime)
            return sample_dual_kdpp_generator(row_keys, self, int(k),
                                              int(num_samples),
                                              backend=backend)
        return sample_dual_kdpp_keyed(row_keys, self, int(k),
                                      backend=backend, runtime=runtime)


def dual_spectrum(V: torch.Tensor, q: torch.Tensor, cache) -> DualSpectrum:
    """DualSpectrum for L = V diag(q) Vᵀ through a ``SpectralCache`` — an
    r×r eigh on a miss, O(1) on a hit. Keyed on ``(id(V), id(q))``, so a
    q-only update is one fresh r×r miss and no N×N work."""
    phi, lams, W = cache.spectrum_lowrank(V, q)
    return DualSpectrum(phi, lams, W)
