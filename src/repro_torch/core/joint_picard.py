"""Joint-Picard (paper Sec. 3.2, App. C, Alg. 3; port of
``repro/core/joint_picard.py``).

One full Picard update L + LΔL, projected back onto Kronecker structure via
the nearest-Kronecker-product problem (Van Loan-Pitsianis rank-1 SVD of the
rearranged matrix). Minimizing ||L^{-1} + Δ - X ⊗ Y||_F and sandwiching
recovers the factors (App. C):

    L1 <- L1 + a (α L1 U L1 - L1),   L2 <- L2 + a (σ/α L2 V L2 - L2)
    α = sgn(U_11) sqrt(σ ||L2 V L2|| / ||L1 U L1||)

No monotonicity guarantee (the paper drops it after Fig. 1 for this reason);
it is kept as a faithful comparison algorithm. As in the reference,
sgn(U_11) = 0 gives α = 0 and a division by zero.

The deprecated ``fit_joint_picard`` shim is not ported: fit through
``learning.fit(algorithm="joint")`` or ``dpp.Kron(factors).fit(batch,
algorithm="joint")``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kron
from .dpp import SubsetBatch
from .krk_picard import theta_matrix_kron


def joint_picard_step(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch,
                      a: float = 1.0, power_iters: int = 50
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep of Alg. 3, where the factors live. M = Θ + L^{-1} -
    (I + L)^{-1} is dense N x N (400 MB at N = 10^4), as in the
    reference."""
    N1, N2 = L1.shape[0], L2.shape[0]
    theta = theta_matrix_kron(L1, L2, batch)
    d1, P1 = torch.linalg.eigh(L1)
    d2, P2 = torch.linalg.eigh(L2)
    lam = torch.outer(d1, d2).reshape(-1)
    # L^{-1} - (I+L)^{-1} = P diag(1/λ - 1/(1+λ)) P^T, P = P1 ⊗ P2.
    w = 1.0 / lam - 1.0 / (1.0 + lam)
    P = torch.kron(P1, P2)
    M = theta + (P * w[None, :]) @ P.T
    del theta, P

    U, sigma, V = kron.nearest_kron_factors(M, N1, N2, iters=power_iters)
    sgn = torch.sign(U[0, 0])
    L1UL1 = L1 @ U @ L1
    L2VL2 = L2 @ V @ L2
    alpha = sgn * torch.sqrt(sigma * torch.linalg.norm(L2VL2)
                             / torch.linalg.norm(L1UL1))
    L1_new = L1 + a * (alpha * L1UL1 - L1)
    L2_new = L2 + a * ((sigma / alpha) * L2VL2 - L2)
    return 0.5 * (L1_new + L1_new.T), 0.5 * (L2_new + L2_new.T)
