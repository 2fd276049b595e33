"""EM baseline for DPP learning (Gillenwater et al. 2014, paper ref [10];
port of ``repro/core/em.py``).

Parametrize the kernel by its eigendecomposition L = V diag(λ) V^T. The DPP is
a mixture of elementary (projection) DPPs indexed by the eigenvector subset J,
with P(k ∈ J) = λ_k / (1 + λ_k).

E-step (exact posterior membership; derivable via Cauchy-Binet):
    q_i(k) = P(k ∈ J | Y_i) = λ_k * v_{k,Y_i}^T L_{Y_i}^{-1} v_{k,Y_i}
(satisfies Σ_k q_i(k) = |Y_i|).

M-step:
    eigenvalues: λ_k <- p̄_k / (1 - p̄_k), p̄_k = (1/n) Σ_i q_i(k)
    eigenvectors: ascent step on the exact log-likelihood wrt V, retracted to
    the Stiefel manifold by QR.

The JAX package's gradient ``jax.grad`` becomes ``torch.autograd.grad`` of
``core.dpp.log_likelihood``. The deprecated ``fit_em`` shim and its
``EMResult`` are not ported: fit through ``learning.fit(algorithm="em")``
or ``dpp.Dense(L).fit(batch)``.
"""

from __future__ import annotations

import torch

from .dpp import SubsetBatch, gather_submatrix, log_likelihood, \
    masked_inv_and_logdet


def e_step(lam: torch.Tensor, V: torch.Tensor, batch: SubsetBatch
           ) -> torch.Tensor:
    """q (n, N): posterior eigenvector-membership probabilities.

    The subsets' rows of V, ``Vy``, are (n, k_max, N): 1.44 GB in float32
    at n = 1000, k_max = 36, N = 10^4, and ``L_Y^{-1} Vy`` another such.
    """
    L = (V * lam[None, :]) @ V.T
    inv, _ = masked_inv_and_logdet(
        gather_submatrix(L, batch.indices, batch.mask))
    m = batch.mask.to(inv.dtype)
    inv = inv * (m[:, :, None] * m[:, None, :])
    Vy = V[batch.indices.long()] * m[:, :, None]        # (n, k_max, N)
    # q_k = λ_k v_{k,Y}^T L_Y^{-1} v_{k,Y}
    return lam * (Vy * torch.bmm(inv, Vy)).sum(1)


def m_step_eigvals(q: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(q.mean(0), 1e-6, 1.0 - 1e-6)
    return p / (1.0 - p)


def eigvec_ascent(lam: torch.Tensor, V: torch.Tensor, batch: SubsetBatch,
                  lr) -> torch.Tensor:
    """One gradient step on phi wrt V, retracted by QR.

    ``torch.linalg.qr`` (LAPACK on the CPU, cuSOLVER on a card) may return
    columns of either sign, as ``jnp.linalg.qr`` may; each column's sign
    is then set toward V's, which makes the result free of the
    convention."""
    with torch.enable_grad():
        Vg = V.detach().requires_grad_(True)
        phi = log_likelihood((Vg * lam.detach()[None, :]) @ Vg.T, batch)
        (g,) = torch.autograd.grad(phi, Vg)
    Vn, _ = torch.linalg.qr(V + lr * g)
    sgn = torch.sign((Vn * V).sum(0))
    return Vn * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[None, :]
