"""Kronecker algebra primitives (port of ``repro/core/kron.py``).

Row-major vec throughout, as in the JAX package: for ``X`` of shape
``(N1, N2)``, ``vec(X) = X.reshape(-1)`` and

    (A ⊗ B) vec(X) = vec(A @ X @ B.T)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
