"""KrK-Picard (paper Alg. 1) — block-coordinate ascent for KronDPP learning
(port of ``repro/core/krk_picard.py``).

Updates (Sec. 3.1, with step size a):
    L1 <- L1 + a * Tr_1((I ⊗ L2^{-1})(L Δ L)) / N2
    L2 <- L2 + a * Tr_2((L1^{-1} ⊗ I)(L Δ L)) / N1

implemented WITHOUT materializing L, Δ or LΔL (Appendix B):

    Tr_1((I⊗L2^{-1})(LΔL)) = L1 A L1 - P1 D1 diag(α) D1 P1^T
        A_{kl}   = Tr(Θ_(kl) L2)
        α_k      = Σ_u d2_u / (1 + d1_k d2_u)
    Tr_2((L1^{-1}⊗I)(LΔL)) = L2 C L2 - P2 diag(β) P2^T
        C        = Σ_{ij} L1_{ij} Θ_(ij)
        β_u      = d2_u^2 Σ_k d1_k / (1 + d1_k d2_u)

By default A and C are accumulated per subset (the Sec. 3.3 sparse-Θ
route), scattered straight into the N1 x N1 and N2 x N2 outputs. The
dense-Θ route (``use_dense_theta=True``) is the paper's batch method: it
builds Θ (N x N) once per evaluation and contracts it with the
partial-trace kernels of ``kernels.ops`` — the hand-written CUDA kernels
on a card, their plain versions on the CPU.

``fit_krk_picard`` is the JAX package's deprecated shim: it warns and
delegates to ``repro_torch.learning.fit`` (or ``dpp.Kron.fit``), the entry
point.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from .._device import DeviceLike
from ..kernels import ops as kernel_ops
from .dpp import SubsetBatch, identity_padded, masked_inv_and_logdet, \
    scatter_theta
from .krondpp import KronDPP


# ---------------------------------------------------------------------------
# Per-subset accumulation of A and C (Appendix B, sparse-Θ specialization)
# ---------------------------------------------------------------------------

def _subset_blocks(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch):
    """Per-subset factor indices r, u (n, k) and factor blocks
    L1[r, r], L2[u, u] (n, k, k) of the batch."""
    N2 = L2.shape[0]
    idx = batch.indices.long()
    r, u = idx // N2, idx % N2
    return (r, u, L1[r[:, :, None], r[:, None, :]],
            L2[u[:, :, None], u[:, None, :]])


def _subset_AC(L1, L2, batch: SubsetBatch):
    """Sums over the batch of each subset's contribution to A (N1 x N1)
    and C (N2 x N2).

    For Y with factor indices (r_a, u_a) and M = L_Y^{-1}:
        A[r_a, r_b] += M[a,b] L2[u_b, u_a]
        C[u_a, u_b] += M[a,b] L1[r_a, r_b]
    (the JAX package writes these as P^T W P and Q^T W' Q with one-hot P,
    Q; here they are scatter-adds).
    """
    N1, N2 = L1.shape[0], L2.shape[0]
    r, u, L1rr, L2uu = _subset_blocks(L1, L2, batch)
    mask = batch.mask
    m2 = mask[:, :, None] & mask[:, None, :]
    M, _ = masked_inv_and_logdet(identity_padded(L1rr * L2uu, mask))
    M = M * m2                                   # zero padded slots
    W = M * L2uu.transpose(1, 2)                 # M[a,b] L2[u_b, u_a]
    Wp = M * L1rr                                # M[a,b] L1[r_a, r_b]
    A = torch.zeros((N1, N1), dtype=L1.dtype, device=L1.device)
    C = torch.zeros((N2, N2), dtype=L2.dtype, device=L2.device)
    A.index_put_((r[:, :, None], r[:, None, :]), W, accumulate=True)
    C.index_put_((u[:, :, None], u[:, None, :]), Wp, accumulate=True)
    return A, C


def accumulate_AC(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean A and C over the batch (the per-subset route)."""
    A, C = _subset_AC(L1, L2, batch)
    return A / batch.n, C / batch.n


def AC_from_dense_theta(theta: torch.Tensor, L1: torch.Tensor,
                        L2: torch.Tensor, backend: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper's batch route: A_{kl} = Tr(Θ_(kl) L2), C = Σ_{ij} L1_{ij} Θ_(ij),
    through ``kernels.ops.partial_trace_A/C`` (``backend`` as there)."""
    N1, N2 = L1.shape[0], L2.shape[0]
    A = kernel_ops.partial_trace_A(theta, L2, N1, N2, backend=backend)
    C = kernel_ops.partial_trace_C(theta, L1, N1, N2, backend=backend)
    return A, C


# ---------------------------------------------------------------------------
# Closed-form (I+L)^{-1} contractions via factor eigendecompositions
# ---------------------------------------------------------------------------

def _alpha_beta(d1: torch.Tensor, d2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    denom = 1.0 + torch.outer(d1, d2)            # (N1, N2)
    alpha = (d2[None, :] / denom).sum(1)         # α_k = Σ_u d2_u/(1+d1_k d2_u)
    beta = (d2[None, :] ** 2 * d1[:, None] / denom).sum(0)   # β_u
    return alpha, beta


# ---------------------------------------------------------------------------
# One KrK-Picard step
# ---------------------------------------------------------------------------

def compute_AC(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch,
               use_dense_theta: bool = False, backend: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (A, C) Θ-statistics of Appendix B, by either route. The dense
    route builds Θ once for both contractions."""
    if use_dense_theta:
        theta = theta_matrix_kron(L1, L2, batch)
        return AC_from_dense_theta(theta, L1, L2, backend=backend)
    return accumulate_AC(L1, L2, batch)


def compute_C(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch,
              use_dense_theta: bool = False, backend: Optional[str] = None
              ) -> torch.Tensor:
    """C alone, for the L2 half-update after a Θ refresh. The dense route
    builds Θ and runs only the C contraction (the JAX package computes A
    there too and lets XLA drop it unused)."""
    if use_dense_theta:
        theta = theta_matrix_kron(L1, L2, batch)
        return kernel_ops.partial_trace_C(theta, L1, L1.shape[0],
                                          L2.shape[0], backend=backend)
    return accumulate_AC(L1, L2, batch)[1]


def krk_picard_step(L1: torch.Tensor, L2: torch.Tensor, batch: SubsetBatch,
                    a: float = 1.0, use_dense_theta: bool = False,
                    fresh_theta: bool = True, backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep of Alg. 1 (updates L1 then L2, per the block-CCCP order).

    fresh_theta=True recomputes the Θ-statistics (and the L1 spectrum) at
    the half-updated kernel before the L2 half — the block-CCCP refresh.
    fresh_theta=False caches the single (A, C) evaluation at (L1, L2)
    across both half-updates, halving the Θ pass per sweep at the cost of
    slightly stale L2 statistics.
    """
    N1, N2 = L1.shape[0], L2.shape[0]

    # ---- update L1 (holding L2) ----
    A, C0 = compute_AC(L1, L2, batch, use_dense_theta, backend)
    d1, P1 = torch.linalg.eigh(L1)
    d2, P2 = torch.linalg.eigh(L2)
    alpha, beta0 = _alpha_beta(d1, d2)
    L1BL1 = (P1 * (d1 ** 2 * alpha)[None, :]) @ P1.T
    L1_new = L1 + (a / N2) * (L1 @ A @ L1 - L1BL1)
    L1_new = 0.5 * (L1_new + L1_new.T)

    # ---- update L2 (holding the NEW L1; alternating block order) ----
    if fresh_theta:
        C = compute_C(L1_new, L2, batch, use_dense_theta, backend)
        _, beta = _alpha_beta(torch.linalg.eigvalsh(L1_new), d2)
    else:
        C, beta = C0, beta0
    B2 = (P2 * beta[None, :]) @ P2.T
    L2_new = L2 + (a / N1) * (L2 @ C @ L2 - B2)
    L2_new = 0.5 * (L2_new + L2_new.T)
    return L1_new, L2_new


def theta_matrix_kron(L1: torch.Tensor, L2: torch.Tensor,
                      batch: SubsetBatch) -> torch.Tensor:
    """Dense Θ = (1/n) Σ_i U_i L_{Y_i}^{-1} U_i^T for the Kronecker kernel
    (N x N, N = N1·N2).

    The JAX package builds one dense N x N per subset and takes their
    mean: n·N² floats, 400 GB at N = 10^4 and n = 1000. Here every
    subset's masked inverse is scatter-added into one N x N buffer, which
    is divided by n (``core.dpp.scatter_theta``): the same sum in N²
    floats, 400 MB at N = 10^4. On an H100 the same batch and factors gave
    the same Θ bit for bit in two builds (``chip_smoke.py`` phase 9).
    """
    _, _, L1rr, L2uu = _subset_blocks(L1, L2, batch)
    inv, _ = masked_inv_and_logdet(identity_padded(L1rr * L2uu, batch.mask))
    return scatter_theta(L1.shape[0] * L2.shape[0], batch.indices,
                         batch.mask, inv)


# ---------------------------------------------------------------------------
# Stochastic KrK-Picard: minibatch of subsets per step (paper Sec. 3.1.2)
# ---------------------------------------------------------------------------

def krk_picard_stochastic_step(L1, L2, minibatch: SubsetBatch, a: float = 1.0,
                               use_dense_theta: bool = False,
                               fresh_theta: bool = True,
                               backend: Optional[str] = None):
    """Identical update with Δ built from a minibatch: O(Nκ^2 + N^{3/2})."""
    return krk_picard_step(L1, L2, minibatch, a, use_dense_theta,
                           fresh_theta, backend)


# ---------------------------------------------------------------------------
# Fit loop — deprecated delegate into the learning engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    model: KronDPP
    log_likelihoods: list
    step_times: list


def fit_krk_picard(model: KronDPP, batch: SubsetBatch, iters: int = 10,
                   a: float = 1.0, minibatch_size: Optional[int] = None,
                   seed: int = 0, track_ll: bool = True,
                   use_dense_theta: bool = False,
                   fresh_theta: bool = True,
                   device: DeviceLike = "cuda") -> FitResult:
    """Run Alg. 1 (batch, or stochastic if minibatch_size is set) on
    ``device``.

    .. deprecated::
        Thin delegate into ``repro_torch.learning.fit``; call
        ``repro_torch.dpp.Kron(factors).fit(batch, ...)`` — the facade —
        for schedules, chunked LL tracking, checkpointing and the
        distributed mode. The stochastic path draws its minibatches from
        ``PRNGKey(seed)``: the JAX package's minibatches for the same
        seed.
    """
    warnings.warn(
        "core.fit_krk_picard is deprecated; use "
        "repro_torch.dpp.Kron(factors).fit(batch, algorithm='krk') instead",
        DeprecationWarning, stacklevel=2)
    from ..learning.api import fit as _fit

    rep = _fit(model, batch,
               algorithm="krk" if minibatch_size is None else "krk-stochastic",
               iters=iters, a=a, minibatch_size=minibatch_size, seed=seed,
               track_ll=track_ll, use_dense_theta=use_dense_theta,
               fresh_theta=fresh_theta, device=device)
    return FitResult(rep.model, rep.log_likelihoods, rep.sweep_times)
