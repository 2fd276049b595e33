"""Batched factored log-likelihood — the engine's objective (port of
``repro/learning/objective.py``).

For a Kronecker kernel L = L_1 ⊗ ... ⊗ L_m and a padded subset batch,

    phi(L) = (1/n) Σ_i log det(L_{Y_i}) - log det(I + L)

is evaluated without ever materializing the N x N kernel:

  * the subset logdets gather per-factor submatrix blocks (Hadamard
    product of m (k, k) blocks) and Cholesky them, batched —
    O(n (κ² m + κ³));
  * log det(I + L) folds the per-factor spectra through
    ``sampling.spectral.log_product_spectrum`` (the log-space fold the
    sampler uses, so a huge product spectrum never overflows) and reduces
    with a softplus — O(Σ N_i³) for the factor ``eigvalsh`` plus O(N).

``log_likelihood_eig`` is the EM parametrization's: the subset logdets
gather from the dense ``V diag(λ) V^T``, and log det(I + L) comes from λ.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.dpp import (SubsetBatch, gather_submatrix, identity_padded,
                        masked_inv_and_logdet)
from ..core.krondpp import KronDPP
from ..sampling.spectral import log_product_spectrum


def masked_subset_logdet(sub: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """log det of masked (identity-padded) PD submatrices (..., k, k)."""
    _, ld = masked_inv_and_logdet(identity_padded(sub, mask))
    return ld


def subset_logdets_factored(factors: Tuple[torch.Tensor, ...],
                            batch: SubsetBatch) -> torch.Tensor:
    """(n,) log det(L_{Y_i}) off the factors — never builds L."""
    return masked_subset_logdet(
        KronDPP(tuple(factors)).submatrix(batch.indices), batch.mask)


def logdet_I_plus_kron(factors: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """log det(I + ⊗_i L_i) = Σ softplus(log λ) over the product spectrum.

    Zero (clipped) factor eigenvalues map to -inf in the log fold, which
    softplus sends to exactly 0 — the correct contribution of a null mode.
    The softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``
    (``torch.nn.functional.softplus`` switches to x above a threshold).
    """
    lams = tuple(torch.clamp_min(torch.linalg.eigvalsh(f), 0.0)
                 for f in factors)
    v = log_product_spectrum(lams)
    return torch.logaddexp(v, torch.zeros_like(v)).sum()


def log_likelihood_factored(factors: Tuple[torch.Tensor, ...],
                            batch: SubsetBatch) -> torch.Tensor:
    """phi(⊗_i L_i) over a padded subset batch, on the factors' device."""
    return (subset_logdets_factored(factors, batch).mean()
            - logdet_I_plus_kron(factors))


def log_likelihood_eig(lam: torch.Tensor, V: torch.Tensor,
                       batch: SubsetBatch) -> torch.Tensor:
    """phi(V diag(λ) V^T) for the EM parametrization: the subset logdets
    gather from the (already dense) reconstruction, but log det(I + L)
    comes free from the eigenvalues — no slogdet."""
    L = (V * lam[None, :]) @ V.T
    _, lds = masked_inv_and_logdet(
        gather_submatrix(L, batch.indices, batch.mask))
    return lds.mean() - torch.log1p(torch.clamp_min(lam, 0.0)).sum()
