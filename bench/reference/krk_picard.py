"""KrK-Picard (Mariet & Sra, NIPS 2016, Alg. 1 with Appendix B's closed
forms), plain, and the log-likelihood it ascends.

For L = L1 ⊗ L2 (N = N1·N2) and n observed subsets Y_i:

    φ(L)  = (1/n) Σ_i log det L_{Y_i} - log det(I + L)
    Θ     = (1/n) Σ_i U_i L_{Y_i}^{-1} U_iᵀ             (N x N)
    A_kl  = Σ_uv Θ[(k,u),(l,v)] L2[v,u]                 (N1 x N1)
    C_uv  = Σ_ij L1[i,j] Θ[(i,u),(j,v)]                 (N2 x N2)
    α_k   = Σ_u d2_u / (1 + d1_k d2_u)                  (L_f = P_f diag(d_f) P_fᵀ)
    β_u   = d2_u² Σ_k d1_k / (1 + d1_k d2_u)

one sweep with step a:

    L1 ← L1 + (a/N2) (L1 A L1 - P1 diag(d1² α) P1ᵀ)       symmetrized
    L2 ← L2 + (a/N1) (L2 C L2 - P2 diag(β) P2ᵀ)           symmetrized,
         with Θ, C and β taken again at the new L1.

Everything is computed in the factors' dtype, every product, inverse and
eigendecomposition at ``precision`` (``reference.precision``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .precision import eigh, inv, matmul, rounded


def _blocks(L1, L2, idx, mask):
    """Each subset's kernel block L_Y (n, k, k), identity in padded slots."""
    N2 = L2.shape[0]
    r, u = idx // N2, idx % N2
    LY = L1[r[:, :, None], r[:, None, :]] * L2[u[:, :, None], u[:, None, :]]
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(idx.shape[1], dtype=L1.dtype, device=L1.device)
    return torch.where(m2, LY, eye.expand_as(LY))


def log_likelihood(L1: torch.Tensor, L2: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor, precision: str = "exact"
                   ) -> torch.Tensor:
    _, logdets = torch.linalg.slogdet(
        rounded(_blocks(L1, L2, idx.long(), mask), precision))
    d1 = eigh(L1, precision)[0].clamp_min(0.0)
    d2 = eigh(L2, precision)[0].clamp_min(0.0)
    return logdets.mean() - torch.log1p(torch.outer(d1, d2)).sum()


def theta(L1, L2, idx, mask, precision: str = "exact") -> torch.Tensor:
    idx = idx.long()
    N = L1.shape[0] * L2.shape[0]
    M = inv(_blocks(L1, L2, idx, mask), precision)
    m2 = mask[:, :, None] & mask[:, None, :]
    rows = idx[:, :, None].expand_as(M)[m2]
    cols = idx[:, None, :].expand_as(M)[m2]
    out = torch.zeros((N, N), dtype=L1.dtype, device=L1.device)
    out.index_put_((rows, cols), M[m2], accumulate=True)
    return out / idx.shape[0]


def sweep(L1: torch.Tensor, L2: torch.Tensor, idx: torch.Tensor,
          mask: torch.Tensor, a: float = 1.0, precision: str = "exact"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    N1, N2 = L1.shape[0], L2.shape[0]
    mm = lambda x, y: matmul(x, y, precision)       # noqa: E731
    T = theta(L1, L2, idx, mask, precision).reshape(N1, N2, N1, N2)
    # A_kl = Σ_u (Θ_(k,l) L2)_uu: the (u, v) blocks times L2 as one product
    A = torch.diagonal(mm(T.permute(0, 2, 1, 3).reshape(-1, N2), L2)
                       .reshape(N1, N1, N2, N2), dim1=2, dim2=3).sum(-1)
    d1, P1 = eigh(L1, precision)
    d2, P2 = eigh(L2, precision)
    alpha = (d2[None, :] / (1.0 + torch.outer(d1, d2))).sum(1)
    G1 = mm(mm(L1, A), L1) - mm(P1 * (d1 * d1 * alpha)[None, :], P1.T)
    L1n = L1 + (a / N2) * G1
    L1n = 0.5 * (L1n + L1n.T)
    T = theta(L1n, L2, idx, mask, precision).reshape(N1, N2, N1, N2)
    # C_uv = Σ_ij L1n[i,j] Θ[(i,u),(j,v)]: one product over (i, j)
    C = mm(L1n.reshape(1, -1), T.permute(0, 2, 1, 3).reshape(N1 * N1, -1)) \
        .reshape(N2, N2)
    e1 = eigh(L1n, precision)[0]
    beta = d2 * d2 * (e1[:, None] / (1.0 + torch.outer(e1, d2))).sum(0)
    G2 = mm(mm(L2, C), L2) - mm(P2 * beta[None, :], P2.T)
    L2n = L2 + (a / N1) * G2
    return L1n, 0.5 * (L2n + L2n.T)


def kron_change(before: Tuple[torch.Tensor, ...],
                after: Tuple[torch.Tensor, ...]) -> float:
    """‖L1'⊗L2' - L1⊗L2‖_F from the factors, without forming either
    product (the norm does not see how a scale is split between the two
    factors)."""
    (a1, a2), (b1, b2) = (tuple(f.double() for f in x)
                          for x in (before, after))
    sq = ((b1 * b1).sum() * (b2 * b2).sum() + (a1 * a1).sum() * (a2 * a2)
          .sum() - 2.0 * (a1 * b1).sum() * (a2 * b2).sum())
    return float(sq.clamp_min(0.0).sqrt())
