"""The model family behind the ``repro_torch.dpp`` facade (port of
``repro/dpp/model.py``).

``Dense(L)``
    an explicit N x N L-ensemble kernel — the m=1 case of the factored
    machinery, so it rides the same sampling pipeline.
``Kron(factors)``
    the paper's Kronecker kernel L = L_1 ⊗ ... ⊗ L_m.

Everything dispatches through the spectrum: per-factor eigendecompositions
held in a ``SpectralCache``, the product spectrum folded in log space. The
port runs on one card; the JAX package's ``runtime=`` placement is not
ported. Operations not ported yet raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from .._device import DeviceLike, as_float, resolve_device
from ..core.dpp import SubsetBatch
from ..core.krondpp import KronDPP, random_krondpp
from ..kernels import ops as kernel_ops
from ..sampling.batched import sample_krondpp_batched
from ..sampling.kdpp import sample_kdpp_batched
from ..sampling.service import SamplingService
from ..sampling.spectral import (FactorSpectrum, SpectralCache, default_cache,
                                 gain_for_expected_size)

#: Guard for operations that must materialize the full N x N kernel.
MAX_DENSE_N = 4096


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1: "
        f"{item})")


def _picks_to_subsets(picks: torch.Tensor,
                      truncated: Optional[torch.Tensor] = None
                      ) -> SubsetBatch:
    """(B, k_max) -1-padded picks -> a padded SubsetBatch carrying the
    sampler's per-row truncation provenance."""
    mask = picks >= 0
    return SubsetBatch(torch.where(mask, picks, torch.zeros_like(picks)),
                       mask, truncated)


class DPPModel:
    """Shared implementation of the facade protocol. Subclasses provide
    ``factors`` and ``_wrap_factors``."""

    # -- structure ----------------------------------------------------------
    @property
    def factors(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    @property
    def m(self) -> int:
        return len(self.factors)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(f.shape[0]) for f in self.factors)

    @property
    def N(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def dense_kernel(self, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        """The full N x N kernel — O(N^2) memory, guarded."""
        if self.N > max_dense:
            raise ValueError(
                f"materializing the full kernel needs N <= max_dense "
                f"({self.N} > {max_dense}); pass max_dense= explicitly to "
                f"opt into O(N^2) memory")
        return KronDPP(tuple(self.factors)).full_matrix()

    # -- spectrum -----------------------------------------------------------
    def spectrum(self, cache: Optional[SpectralCache] = None
                 ) -> FactorSpectrum:
        """Per-factor eigendecompositions off a ``SpectralCache`` —
        O(Σ N_i³) on first touch, O(1) later for the same factors."""
        cache = cache if cache is not None else default_cache()
        return cache.spectrum(self)

    def expected_size(self, cache: Optional[SpectralCache] = None) -> float:
        """E|Y| = Σ λ/(1+λ) off the log-space product spectrum."""
        return self.spectrum(cache).expected_size()

    def rescale(self, expected_size: float,
                cache: Optional[SpectralCache] = None) -> "DPPModel":
        """Scalar-rescale the kernel so E|Y| hits ``expected_size``.
        Raises ``ValueError`` outside the achievable range (0, rank)."""
        spec = self.spectrum(cache)
        g = gain_for_expected_size(spec.log_eigenvalues(), expected_size)
        gm = g ** (1.0 / self.m)
        return self._wrap_factors(tuple(f * gm for f in self.factors))

    # -- sampling -----------------------------------------------------------
    def sample(self, generator: torch.Generator,
               batch_shape: Union[int, Tuple[int, ...]] = (),
               k: Optional[int] = None, k_max: Optional[int] = None,
               cache: Optional[SpectralCache] = None,
               device: DeviceLike = "cuda") -> SubsetBatch:
        """Exact DPP (or, with ``k``, k-DPP) samples as a ``SubsetBatch``,
        drawn on ``device`` from ``generator`` (which must live there).
        ``batch_shape`` gives n = prod(shape) rows. DPP draws carry
        ``truncated`` provenance and ``k_max`` overrides their phase-2
        budget (default E|Y| + 6σ); k-DPP rows hold exactly k items (fewer,
        -1 padded, below the kernel's rank). Phase 2 runs the CUDA kernel
        on the card and its plain version on the CPU."""
        dev = resolve_device(device)
        shape = (batch_shape,) if isinstance(batch_shape, int) \
            else tuple(batch_shape)
        n = 1
        for s in shape:
            n *= int(s)
        spec = self.spectrum(cache).to(dev)
        if k is not None:
            # exact-k draws cannot overflow their k-slot budget
            return _picks_to_subsets(sample_kdpp_batched(generator, spec,
                                                         int(k), n))
        if k_max is None:
            k_max = spec.suggested_k_max()
        picks, _, truncated = sample_krondpp_batched(generator, spec,
                                                     int(k_max), n)
        return _picks_to_subsets(picks, truncated)

    def service(self, **kwargs) -> SamplingService:
        """A micro-batching ``SamplingService`` over this model (submit /
        coalesce / one batched call / scatter); takes ``seed=``,
        ``k_max=``, ``max_batch=``, ``device=`` (default "cuda")."""
        return SamplingService(self, **kwargs)

    # -- MAP ----------------------------------------------------------------
    def map(self, k: int, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        """Greedy MAP subset of size k (Chen et al. 2018 fast greedy,
        ``kernels.ops.greedy_map_kdpp``: the CUDA update kernel on the
        card) as (k,) int32 on the model's device. Kron kernels run on the
        dense materialization, guarded by ``max_dense``."""
        return kernel_ops.greedy_map_kdpp(self.dense_kernel(max_dense),
                                          int(k))

    # -- not ported yet -----------------------------------------------------
    def serving(self, config=None, **kwargs):
        _not_ported("serving (the async tier)", "PRNG twin and serving")

    def log_prob(self, batch: SubsetBatch, cache=None):
        _not_ported("log_prob", "log_prob, marginal and condition")

    def log_likelihood(self, batch: SubsetBatch, cache=None):
        _not_ported("log_likelihood", "log_prob, marginal and condition")

    def marginal(self, idx, cache=None):
        _not_ported("marginal", "log_prob, marginal and condition")

    def condition(self, observed, max_dense: int = MAX_DENSE_N):
        _not_ported("condition", "log_prob, marginal and condition")

    def fit(self, batch: SubsetBatch, algorithm=None, **fit_kwargs):
        _not_ported("fit of a Dense model (EM)", "learning: EM")

    # -- subclass hooks -----------------------------------------------------
    def _wrap_factors(self, factors: Tuple[torch.Tensor, ...]
                      ) -> "DPPModel":
        raise NotImplementedError


class Dense(DPPModel):
    """An explicit N x N L-ensemble kernel behind the facade protocol."""

    def __init__(self, L, device: DeviceLike = "cuda"):
        self.L = as_float(L, device)

    def __repr__(self):
        return f"Dense(N={self.N})"

    @property
    def factors(self) -> Tuple[torch.Tensor, ...]:
        return (self.L,)

    def dense_kernel(self, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        return self.L

    def _wrap_factors(self, factors):
        return Dense(factors[0], device=self.device)


class Kron(DPPModel):
    """The paper's Kronecker kernel L = L_1 ⊗ ... ⊗ L_m. ``factors`` may
    be tensors, numpy arrays or a ``core.KronDPP``; they are placed on
    ``device`` as float32."""

    def __init__(self, factors, device: DeviceLike = "cuda"):
        if isinstance(factors, KronDPP):
            factors = factors.factors
        self._factors = tuple(as_float(f, device) for f in factors)

    def __repr__(self):
        return f"Kron(sizes={self.sizes})"

    @property
    def factors(self) -> Tuple[torch.Tensor, ...]:
        return self._factors

    def to_krondpp(self) -> KronDPP:
        return KronDPP(self._factors)

    def fit(self, batch: SubsetBatch, algorithm: str = "krk",
            **fit_kwargs):
        """Maximum-likelihood fit through ``repro_torch.learning.fit``
        (KrK-Picard: "krk" or "krk-stochastic"). Returns the engine's
        ``FitReport`` with ``report.model`` wrapped back into a ``Kron``.
        All engine kwargs (iters, schedule, minibatch_size,
        use_dense_theta, fresh_theta, log_every, health, backend, device,
        ...) pass through; ``device`` defaults to "cuda"."""
        from ..learning.api import fit as _fit
        rep = _fit(self._factors, batch, algorithm=algorithm, **fit_kwargs)
        fitted = Kron(rep.model.factors, device=rep.model.factors[0].device)
        return dataclasses.replace(rep, model=fitted)

    def _wrap_factors(self, factors):
        return Kron(factors, device=self.device)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def from_kernel(L, device: DeviceLike = "cuda") -> Dense:
    """Facade model over an explicit dense kernel."""
    return Dense(L, device=device)


def from_factors(*factors, device: DeviceLike = "cuda") -> Kron:
    """Facade model over Kronecker factors (pass 2 or 3 PD matrices)."""
    if len(factors) == 1 and isinstance(factors[0], (tuple, list)):
        factors = tuple(factors[0])
    return Kron(factors, device=device)


def random_kron(generator: torch.Generator, sizes: Sequence[int],
                device: DeviceLike = "cuda") -> Kron:
    """Paper Sec. 5.1 random init (L_i = X^T X + 1e-3 I,
    X ~ U[0, sqrt(2)])."""
    return Kron(random_krondpp(generator, tuple(sizes), device=device),
                device=device)
