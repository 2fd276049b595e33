"""Feature maps that turn raw item embeddings into low-rank DPP bases (a
copy of ``repro/lowrank/features.py``: the same numpy code, so the same
seed gives the same arrays in both packages).

Both return an (N, r) matrix Ṽ with Ṽ Ṽᵀ ≈ the RBF similarity kernel
exp(-γ‖x_i − x_j‖²), so ``LowRank(Ṽ)`` (optionally with quality scores
q) replaces an O(N²)-memory dense RBF kernel. Host-side numpy on purpose:
feature construction is one-shot data-pipeline work, not a hot path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _median_gamma(X: np.ndarray, rng: np.random.Generator,
                  sample: int = 256) -> float:
    """Median heuristic γ = 1/(2·median²) on a subsample of pair
    distances — O(sample²) regardless of N."""
    n = X.shape[0]
    idx = rng.choice(n, size=min(n, sample), replace=False)
    S = X[idx]
    d2 = ((S[:, None, :] - S[None, :, :]) ** 2).sum(-1)
    med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
    return 1.0 / max(med, 1e-12)


def nystrom_features(X, rank: int, gamma: Optional[float] = None,
                     seed: int = 0, reg: float = 1e-6) -> np.ndarray:
    """Nyström feature map for the RBF kernel: pick ``rank`` landmark
    rows Z, return Ṽ = K_{XZ} (K_{ZZ} + reg I)^{-1/2} — (N, rank), so
    Ṽ Ṽᵀ is the standard Nyström approximation K_{XZ} K_{ZZ}⁻¹ K_{ZX}.
    Exact (up to reg) when the landmarks span the data — in particular
    when rank == N, which is what the small-N parity test pins. Only
    N×rank and rank×rank blocks are ever formed.
    """
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    rank = min(int(rank), n)
    rng = np.random.default_rng(seed)
    if gamma is None:
        gamma = _median_gamma(X, rng)
    land = np.sort(rng.choice(n, size=rank, replace=False)) \
        if rank < n else np.arange(n)
    Z = X[land]
    d2_nz = ((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)   # (N, rank)
    K_nz = np.exp(-gamma * d2_nz)
    K_zz = K_nz[land]
    lam, U = np.linalg.eigh(0.5 * (K_zz + K_zz.T) + reg * np.eye(rank))
    inv_sqrt = U @ np.diag(np.maximum(lam, reg) ** -0.5) @ U.T
    return (K_nz @ inv_sqrt).astype(np.float32)


def random_fourier_features(X, rank: int, gamma: Optional[float] = None,
                            seed: int = 0) -> np.ndarray:
    """Random Fourier feature map (Rahimi & Recht) for the RBF kernel:
    Ṽ[i] = √(2/rank)·cos(Ω x_i + β) with Ω ~ N(0, 2γ), β ~ U[0, 2π], so
    E[Ṽ Ṽᵀ] = exp(-γ‖x_i − x_j‖²). O(N·d·rank) — no kernel block at
    all, the right choice when even N×rank Nyström blocks are too wide.
    """
    X = np.asarray(X, np.float64)
    rng = np.random.default_rng(seed)
    if gamma is None:
        gamma = _median_gamma(X, rng)
    Omega = rng.normal(0.0, np.sqrt(2.0 * gamma), (X.shape[1], int(rank)))
    beta = rng.uniform(0.0, 2.0 * np.pi, (int(rank),))
    return (np.sqrt(2.0 / rank) * np.cos(X @ Omega + beta)) \
        .astype(np.float32)
