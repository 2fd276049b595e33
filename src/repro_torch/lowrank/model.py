"""``LowRank(V, q)`` — the third facade model, entirely in the dual (port of
``repro/lowrank/model.py``).

L = V diag(q) Vᵀ with a shared (N, r) diversity basis V and per-item
quality scores q >= 0. Every facade operation runs on the rank-r dual
factorization (``dual.DualSpectrum``): an r×r eigh plus O(Nr) products;
the N×N kernel exists only behind the ``MAX_DENSE_N`` guard
(``dense_kernel``). The ``SpectralCache`` keys the dual on
``(id(V), id(q))``, so one shared V with per-tenant q costs one r×r eigh
per tenant and no N×N work.

Every call runs where V lives: ``device="cuda"`` by default, raising
without a card unless ``device="cpu"`` is passed. V and q are float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import DeviceLike, as_float
from ..core.dpp import SubsetBatch
from ..dpp.model import MAX_DENSE_N, DPPModel, _as_index_set
from ..sampling.batched import is_mesh_runtime
from ..sampling.spectral import (SpectralCache, default_cache,
                                 gain_for_expected_size)
from .dual import DualSpectrum, dual_spectrum


class LowRank(DPPModel):
    """Low-rank L-ensemble L = V diag(q) Vᵀ behind the facade protocol.

    V: (N, r) diversity basis rows (any real matrix, r <= N for a
       nondegenerate model).
    q: (N,) nonnegative per-item quality scores; defaults to ones.

    The kernel's rank is at most r, so draws never exceed r items and
    ``rescale`` targets must lie in (0, rank). A tensor already float32 on
    ``device`` is kept as it is (the cache keys on its identity)."""

    _default_algorithm = "lowrank"

    def __init__(self, V, q=None, device: DeviceLike = "cuda"):
        V = as_float(V, device)
        if V.dim() != 2:
            raise ValueError(f"V must be (N, r), got shape {tuple(V.shape)}")
        if q is None:
            q = torch.ones((V.shape[0],), dtype=V.dtype, device=V.device)
        else:
            q = as_float(q, V.device)
            if tuple(q.shape) != (V.shape[0],):
                raise ValueError(
                    f"q must be ({V.shape[0]},) to match V's rows, got "
                    f"shape {tuple(q.shape)}")
        self._V = V
        self._q = q

    def __repr__(self):
        return f"LowRank(N={self.N}, rank={self.rank})"

    # -- structure ----------------------------------------------------------
    @property
    def V(self) -> torch.Tensor:
        return self._V

    @property
    def q(self) -> torch.Tensor:
        return self._q

    @property
    def rank(self) -> int:
        return int(self._V.shape[1])

    @property
    def factors(self) -> Tuple[torch.Tensor, ...]:
        raise TypeError(
            "LowRank has no N x N factor representation; use .V/.q, the "
            "dual spectrum(), or dense_kernel() under the max_dense guard")

    @property
    def m(self) -> int:
        return 1

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (self.N,)

    @property
    def N(self) -> int:
        return int(self._V.shape[0])

    @property
    def device(self) -> torch.device:
        return self._V.device

    def _phi(self) -> torch.Tensor:
        """φ = V·√q (N, r), so L = φφᵀ."""
        return self._V * torch.sqrt(torch.clamp_min(self._q, 0.0))[:, None]

    def dense_kernel(self, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        """The full N x N kernel φφᵀ — O(N²) memory, guarded."""
        if self.N > max_dense:
            raise ValueError(
                f"materializing the full kernel needs N <= max_dense "
                f"({self.N} > {max_dense}); pass max_dense= explicitly to "
                f"opt into O(N^2) memory")
        phi = self._phi()
        return phi @ phi.T

    # -- spectrum -----------------------------------------------------------
    def spectrum(self, cache: Optional[SpectralCache] = None,
                 runtime=None) -> DualSpectrum:
        """The rank-r dual spectrum off a ``SpectralCache`` — one r×r eigh
        on first touch of this (V, q) pair, O(1) after. Under a ``Mesh``
        runtime φ, λ and W are placed on the mesh's devices (pinned,
        ``Mesh.pin_spectrum``, so the transfer is paid once a cache
        entry)."""
        cache = cache if cache is not None else default_cache()
        spec = dual_spectrum(self._V, self._q, cache)
        return runtime.pin_spectrum(spec) if is_mesh_runtime(runtime) \
            else spec

    def rescale(self, expected_size: float,
                cache: Optional[SpectralCache] = None) -> "LowRank":
        """Scalar gain on q so E|Y| hits ``expected_size``, solved on the r
        dual eigenvalues. Raises ``ValueError`` outside (0, rank)."""
        spec = self.spectrum(cache)
        g = gain_for_expected_size(spec.log_eigenvalues(), expected_size)
        return LowRank(self._V, self._q * g, device=self.device)

    # sample() and service() are inherited: the batched samplers dispatch
    # to the dual engine through the DualSpectrum's sample_rows /
    # sample_rows_kdpp hooks, and the Host oracle (m = 1) runs on the
    # guarded dense kernel.

    # -- likelihood ---------------------------------------------------------
    def log_prob(self, batch: SubsetBatch,
                 cache: Optional[SpectralCache] = None) -> torch.Tensor:
        """(n,) log P(Y_i) off the dual, on the model's device:
        det(L_Y) = det(φ_Y φ_Yᵀ) per subset (a |Y| × |Y| slogdet of gathered
        feature rows; a subset larger than the rank has a singular Gram
        and log P = -inf), normalizer log det(I_N + L) = log det(I_r + C)
        = Σ softplus(log d)."""
        dev = self.device
        spec = self.spectrum(cache)
        ll = spec.log_eigenvalues()
        log_z = torch.logaddexp(ll, torch.zeros_like(ll)).sum()
        idx = batch.indices.to(device=dev, dtype=torch.int64)
        mask = batch.mask.to(dev)
        P = spec.phi[idx]                                  # (n, k, r)
        S = P @ P.transpose(1, 2)
        m2 = mask[:, :, None] & mask[:, None, :]
        eye = torch.eye(S.shape[-1], dtype=S.dtype, device=dev)
        sign, ld = torch.linalg.slogdet(torch.where(m2, S, eye))
        return torch.where(sign > 0, ld, torch.full_like(ld, -torch.inf)) \
            - log_z

    # -- marginals ----------------------------------------------------------
    def marginal_kernel_submatrix(self, idx,
                                  cache: Optional[SpectralCache] = None
                                  ) -> torch.Tensor:
        """K[idx, idx] for K = L(L+I)⁻¹ = φ (C+I)⁻¹ φᵀ: gather the k
        feature rows, rotate into the dual eigenbasis, scale by 1/(1+d) —
        O(k r² + k² r), no N×N."""
        spec = self.spectrum(cache)
        idx = _as_index_set(idx, self.N, spec.device)
        P = spec.phi[idx] @ spec.W                          # (k, r)
        inv1pd = torch.sigmoid(-spec.log_eigenvalues())     # 1/(1+d)
        return (P * inv1pd[None, :]) @ P.T

    # -- conditioning -------------------------------------------------------
    def condition(self, observed, max_dense: int = MAX_DENSE_N
                  ) -> "LowRank":
        """The conditional DPP given ``observed ⊆ Y``, closed in feature
        space: the Schur complement of L on the complement rows is
        (φ_Ā Π)(φ_Ā Π)ᵀ with the rank-(r-|A|) projector
        Π = I_r − φ_Aᵀ (φ_A φ_Aᵀ)⁻¹ φ_A — O(Nr + |A|³), another
        ``LowRank`` (``max_dense`` is never needed; kept for the protocol).
        Raises ``ValueError`` when L_A is singular (P(A ⊆ Y) = 0)."""
        A = _as_index_set(observed, self.N, self.device)
        if A.numel() == 0:
            return self
        phi = self._phi()
        phi_A = phi[A]                                      # (a, r)
        G = phi_A @ phi_A.T
        # torch.linalg.cholesky raises where jnp returns NaN: cholesky_ex
        # reports it in info. A pivot² vanishing relative to the Gram's
        # scale is numerically singular too (duplicated rows leave a
        # float-noise pivot that potrf may accept).
        chol, info = torch.linalg.cholesky_ex(G)
        piv2 = torch.diagonal(chol) ** 2
        tol = 1e-6 * torch.max(torch.diagonal(G))
        if int(info) != 0 or not bool(torch.isfinite(chol).all()) \
                or bool((piv2 <= tol).any()):
            raise ValueError(
                f"cannot condition on {observed!r}: L_A is singular "
                f"(P(A ⊆ Y) = 0 — e.g. linearly dependent items of a "
                f"rank-deficient kernel)")
        keep = torch.ones(self.N, dtype=torch.bool, device=self.device)
        keep[A] = False
        X = torch.cholesky_solve(phi_A, chol)               # G⁻¹ φ_A
        proj = torch.eye(phi.shape[1], dtype=phi.dtype,
                         device=self.device) - phi_A.T @ X
        return LowRank(phi[keep] @ proj, device=self.device)

    # -- MAP ----------------------------------------------------------------
    def map(self, k: int, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        """Greedy MAP in feature space, in float64 on the model's device:
        the det gain of item i given the selected set S is its residual
        feature mass ‖φ_i‖² − ‖B_Sᵀ φ_i‖² (B_S an orthonormal basis of the
        selected rows), the dense fast-greedy gains in O(N r k) without
        the N×N kernel (``max_dense`` unused). Returns (k,) int32. No step
        waits for the host."""
        phi = self._phi().to(torch.float64)
        N, r = phi.shape
        k = int(k)
        dev = phi.device
        resid = (phi * phi).sum(dim=1)
        B = torch.zeros((r, min(k, r)), dtype=torch.float64, device=dev)
        picked = torch.zeros(N, dtype=torch.bool, device=dev)
        picks = torch.empty(k, dtype=torch.int64, device=dev)
        for t in range(k):
            gains = torch.where(picked, -torch.inf, resid)
            i = torch.argmax(gains)
            picks[t] = i
            picked[i] = True
            if t < B.shape[1]:
                Bt = B[:, :t]
                b = phi[i] - Bt @ (Bt.T @ phi[i])
                b = b - Bt @ (Bt.T @ b)
                n2 = b @ b
                ok = n2 > 1e-12
                b = torch.where(ok, b / torch.sqrt(torch.where(ok, n2, 1.0)),
                                torch.zeros_like(b))
                B[:, t] = b
                resid = torch.where(
                    ok, torch.clamp_min(resid - (phi @ b) ** 2, 0.0), resid)
        return picks.to(torch.int32)

    # -- learning -----------------------------------------------------------
    def fit(self, batch: SubsetBatch, algorithm: Optional[str] = None,
            max_dense: int = MAX_DENSE_N, **fit_kwargs):
        """Maximum-likelihood fit of (V, q) in the dual
        (``algorithm="lowrank"``: a Picard fixed-point step on q with a
        projected-gradient step on V, ``repro_torch.learning.fit``).
        Returns the ``FitReport`` with ``report.model`` a ``LowRank`` on
        the fit's device (``device=``, default "cuda")."""
        from ..learning.api import fit as _fit
        if algorithm is None:
            algorithm = self._default_algorithm
        if algorithm != "lowrank":
            raise ValueError(
                f"LowRank models learn with algorithm='lowrank' (dual-"
                f"space Picard + projected gradient); {algorithm!r} needs "
                f"an explicit Dense/Kron kernel")
        return _fit(self, batch, algorithm="lowrank", **fit_kwargs)

    # -- subclass hooks -----------------------------------------------------
    def _wrap_factors(self, factors):
        raise TypeError("LowRank is not factor-parameterized")

    def _fit_params(self, algorithm: str, max_dense: int = MAX_DENSE_N):
        return self
