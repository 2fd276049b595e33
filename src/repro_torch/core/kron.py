"""Kronecker algebra primitives (port of ``repro/core/kron.py``).

Row-major vec throughout, as in the JAX package: for ``X`` of shape
``(N1, N2)``, ``vec(X) = X.reshape(-1)`` and

    (A ⊗ B) vec(X) = vec(A @ X @ B.T)

Block indexing follows the paper: for ``M`` of shape ``(N1*N2, N1*N2)``,
``M_(ij)`` is the ``N2 x N2`` block ``M.reshape(N1, N2, N1, N2)[i, :, j, :]``.
These are plain tensor code on the inputs' device; the hand-written
Kronecker matvec kernel is ``kernels.kron_matvec``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# Basic products
# ---------------------------------------------------------------------------

def kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense Kronecker product (reference / small sizes only)."""
    return torch.kron(A, B)


def kron_matvec(A: torch.Tensor, B: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """``(A ⊗ B) x`` without materializing the product; ``x`` is a vector
    of length ``A.shape[1] * B.shape[1]`` or a batch ``(..., that)``."""
    p, q = A.shape
    r, s = B.shape
    batch = x.shape[:-1]
    X = x.reshape(*batch, q, s)
    Y = torch.einsum("pq,...qs,rs->...pr", A, X, B)
    return Y.reshape(*batch, p * r)


def kron_matmat(A: torch.Tensor, B: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """``(A ⊗ B) @ X`` for ``X`` of shape ``(q*s, m)``."""
    return kron_matvec(A, B, X.T).T


def kron_quad(A: torch.Tensor, B: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
    """``(A ⊗ B) X (A ⊗ B)^T`` for X of shape (N, N), N = N1·N2."""
    N1, N2 = A.shape[0], B.shape[0]
    X4 = X.reshape(N1, N2, N1, N2)
    Y = torch.einsum("ik,uw,kwlz,jl,vz->iujv", A, B, X4, A, B)
    return Y.reshape(N1 * N2, N1 * N2)


def kron_solve(A_chol: torch.Tensor, B_chol: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Solve ``(A ⊗ B) x = y`` from the lower Cholesky factors of A and B,
    by ``(A ⊗ B)^{-1} = A^{-1} ⊗ B^{-1}`` (Prop. 2.1(ii))."""
    p, r = A_chol.shape[0], B_chol.shape[0]
    Y = y.reshape(p, r)
    Z = torch.cholesky_solve(Y, A_chol)                  # A^{-1} Y
    X = torch.cholesky_solve(Z.T, B_chol).T              # ... B^{-T}
    return X.reshape(-1)


# ---------------------------------------------------------------------------
# Partial traces (Def. 2.3)
# ---------------------------------------------------------------------------

def partial_trace_1(M: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """``Tr_1(M)[i,j] = Tr(M_(ij))`` — shape ``(n1, n1)``."""
    return torch.einsum("iuju->ij", M.reshape(n1, n2, n1, n2))


def partial_trace_2(M: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """``Tr_2(M) = sum_i M_(ii)`` — shape ``(n2, n2)``."""
    return torch.einsum("iuiv->uv", M.reshape(n1, n2, n1, n2))


# ---------------------------------------------------------------------------
# Spectral structure (Cor. 2.2)
# ---------------------------------------------------------------------------

def kron_eigh(L1: torch.Tensor, L2: torch.Tensor
              ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                         Tuple[torch.Tensor, torch.Tensor]]:
    """Eigendecompose both factors: ``L = (P1⊗P2)(D1⊗D2)(P1⊗P2)^T`` in
    O(N1³ + N2³)."""
    d1, P1 = torch.linalg.eigh(L1)
    d2, P2 = torch.linalg.eigh(L2)
    return (d1, P1), (d2, P2)


def kron_eigvals(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All N1*N2 eigenvalues of L1 ⊗ L2, row-major pair order (i*N2+j)."""
    return torch.outer(d1, d2).reshape(-1)


def kron_eigvec(P1: torch.Tensor, P2: torch.Tensor, i, j) -> torch.Tensor:
    """Eigenvector of L1⊗L2 for eigenvalue d1[i]*d2[j]; O(N) per vector."""
    return torch.outer(P1[:, i], P2[:, j]).reshape(-1)


def logdet_I_plus_kron(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """``log det(I + L1 ⊗ L2)`` from factor eigenvalues — O(N), not
    O(N³)."""
    return torch.log1p(torch.outer(d1, d2)).sum()


# ---------------------------------------------------------------------------
# Submatrices of a Kronecker product: L_Y = L1[r, r'] * L2[u, u']
# ---------------------------------------------------------------------------

def split_indices(idx: torch.Tensor, n2: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ground-set index -> (row-factor index, col-factor index)."""
    return torch.div(idx, n2, rounding_mode="floor"), torch.remainder(idx, n2)


def split_indices_multi(idx: torch.Tensor, sizes: Sequence[int]
                        ) -> Tuple[torch.Tensor, ...]:
    """Row-major mixed-radix decomposition of global ground-set indices
    into per-factor indices — the index-order convention of the package."""
    parts = []
    rem = idx
    for s in tuple(sizes)[::-1]:
        parts.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode="floor")
    return tuple(parts[::-1])


def kron_submatrix(L1: torch.Tensor, L2: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``(L1 ⊗ L2)[idx, idx]`` gathered in O(k²), never materializing L."""
    r, u = split_indices(idx.long(), L2.shape[0])
    return L1[r[:, None], r[None, :]] * L2[u[:, None], u[None, :]]


# ---------------------------------------------------------------------------
# Nearest Kronecker product (Van Loan & Pitsianis; paper App. C)
# ---------------------------------------------------------------------------

def vlp_rearrange(M: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """R[(i*n1+j), :] = vec(M_(ij)) — shape (n1*n1, n2*n2). The rank-1
    SVD of R gives the nearest Kronecker factors (Thm. C.1)."""
    return M.reshape(n1, n2, n1, n2).permute(0, 2, 1, 3).reshape(
        n1 * n1, n2 * n2)


def vlp_unrearrange(R: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    return R.reshape(n1, n1, n2, n2).permute(0, 2, 1, 3).reshape(
        n1 * n2, n1 * n2)


def dominant_singular(R: torch.Tensor, iters: int = 50
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power iteration for the leading singular triple (u, s, v) of R,
    from the ones start and for a fixed ``iters`` steps (the paper's
    Alg. 3 ``power_method``)."""
    n = R.shape[1]
    v = torch.ones((n,), dtype=R.dtype, device=R.device) / n ** 0.5
    for _ in range(int(iters)):
        u = R @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-30)
        v = R.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-30)
    u = R @ v
    s = torch.linalg.vector_norm(u)
    return u / (s + 1e-30), s, v


def nearest_kron_factors(M: torch.Tensor, n1: int, n2: int, iters: int = 50
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, s, V) with M ≈ s * (U ⊗ V), ||U||_F = ||V||_F = 1; U and V are
    symmetrized (a symmetric M has symmetric exact factors)."""
    u, s, v = dominant_singular(vlp_rearrange(M, n1, n2), iters)
    U = u.reshape(n1, n1)
    V = v.reshape(n2, n2)
    return 0.5 * (U + U.T), s, 0.5 * (V + V.T)
