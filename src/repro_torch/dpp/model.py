"""The model family behind the ``repro_torch.dpp`` facade (port of
``repro/dpp/model.py``).

``Dense(L)``
    an explicit N x N L-ensemble kernel — the m=1 case of the factored
    machinery, so it rides the same sampling pipeline.
``Kron(factors)``
    the paper's Kronecker kernel L = L_1 ⊗ ... ⊗ L_m.

Everything dispatches through the spectrum: per-factor eigendecompositions
held in a ``SpectralCache``, the product spectrum folded in log space. WHERE
the work runs is ``repro_torch.dpp.runtime``: ``sample`` / ``spectrum`` /
``service`` / ``serving`` / ``fit`` take ``runtime=`` (``Local()``, the
default, on ``device``; ``Mesh(...)`` sharded over its devices; ``Host()``
the numpy oracle) — the pre-runtime ``backend=`` strings survive only as
DeprecationWarning shims. The low-rank family ``LowRank(V, q)`` lives in
``repro_torch.lowrank`` and subclasses ``DPPModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from .._device import FLOAT, DeviceLike, as_float, resolve_device
from ..core.dpp import SubsetBatch
from ..core.kron import split_indices_multi
from ..core.krondpp import KronDPP, random_krondpp
from ..kernels import ops as kernel_ops
from ..sampling.batched import is_mesh_runtime, sample_krondpp_batched
from ..sampling.kdpp import sample_kdpp_batched
from ..sampling.service import SamplingService
from ..sampling.spectral import (FactorSpectrum, SpectralCache, default_cache,
                                 gain_for_expected_size)
from . import runtime as runtime_mod

#: Guard for operations that must materialize the full N x N kernel.
MAX_DENSE_N = 4096


def _as_index_set(idx, n: int, device: torch.device) -> torch.Tensor:
    """Validate and canonicalize a host-side index set: 1-D, in range,
    deduplicated (inclusion events have set semantics). Returns sorted
    int64 indices on ``device``."""
    arr = np.atleast_1d(np.asarray(idx, np.int64))
    if arr.ndim != 1:
        raise ValueError(f"index set must be scalar or 1-D, got {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() >= n):
        raise ValueError(f"indices out of range [0, {n}): {idx!r}")
    return torch.from_numpy(np.unique(arr)).to(device)


def _place_spectrum(spec: FactorSpectrum,
                    runtime: Optional[runtime_mod.Runtime]
                    ) -> FactorSpectrum:
    """A spectrum's tensors on a mesh runtime's first data shard's device,
    copied to its other devices through the mesh's identity-pinned cache
    (``Mesh.pin_spectrum``: spectrum tensors are themselves cached, so
    repeated sampling against one kernel pays the transfer once, not a
    call). The identity for Local/Host/None."""
    return runtime.pin_spectrum(spec) if is_mesh_runtime(runtime) else spec


def _host_seed(key) -> int:
    """The numpy seed of a Host draw: ``randint(key, (), 0, int32 max)``,
    the JAX package's."""
    if isinstance(key, torch.Generator):
        raise ValueError("the Host runtime seeds numpy from a PRNG key "
                         "(repro_torch.random.PRNGKey), not a generator")
    from .. import random as prng
    return int(prng.randint(key, (), 0, np.iinfo(np.int32).max))


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
    def spectrum(self, cache: Optional[SpectralCache] = None,
                 runtime: Optional[runtime_mod.Runtime] = None
                 ) -> FactorSpectrum:
        """Per-factor eigendecompositions off a ``SpectralCache`` —
        O(Σ N_i³) on first touch, O(1) later for the same factors. Under a
        ``Mesh`` runtime the spectrum is placed on the mesh's devices
        (``_place_spectrum``; the cache entry itself stays where the
        factors live)."""
        cache = cache if cache is not None else default_cache()
        return _place_spectrum(cache.spectrum(self), runtime)

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
    def sample(self, key, batch_shape: Union[int, Tuple[int, ...]] = (),
               k: Optional[int] = None,
               runtime: Optional[runtime_mod.Runtime] = None,
               k_max: Optional[int] = None,
               cache: Optional[SpectralCache] = None,
               backend: Optional[str] = None, *,
               device: DeviceLike = "cuda") -> SubsetBatch:
        """Exact DPP (or, with ``k``, k-DPP) samples as a ``SubsetBatch``,
        drawn on ``device``.

        key: a PRNG key (``repro_torch.random``, or the JAX package's uint32
            key (2,)), moved to ``device``: the JAX package's rows for the
            same key; or a ``torch.Generator`` living on ``device`` (Local
            only).
        batch_shape: n = prod(shape) rows. DPP draws carry ``truncated``
            provenance and ``k_max`` overrides their phase-2 budget
            (default E|Y| + 6σ); k-DPP rows hold exactly k items (fewer,
            -1 padded, below the kernel's rank). Phase 2 runs the CUDA
            kernel on the card and its plain version on the CPU.
        runtime: execution placement (``repro_torch.dpp.runtime``):
            ``Local()`` / None — one batched call on ``device``;
            ``Mesh(...)`` — the same pipeline with the rows' keys cut into
            one shard a data-axis position, each on its device (draws equal
            Local's bit for bit on shared keys; ``device`` must be the
            mesh's first data shard's); ``Host()`` — the numpy reference
            oracle (k=None only), one eigh and one subset a draw, the batch
            returned on ``device``.
        backend: deprecated placement strings ("device"/"host"), shimmed
            onto runtimes with a DeprecationWarning."""
        with obs.spans.start_span("dpp.sample"):
            rt = runtime_mod.resolve(runtime, backend=backend)
            dev = resolve_device(device)
            shape = (batch_shape,) if isinstance(batch_shape, int) \
                else tuple(batch_shape)
            n = 1
            for s in shape:
                n *= int(s)
            if rt.kind == "host":
                if k is not None:
                    raise ValueError("the Host runtime implements the "
                                     "plain DPP oracle only (k=None); use "
                                     "Local/Mesh for k-DPP draws")
                return self._sample_host(key, n, dev)
            if rt.is_mesh:
                rt.home(dev)
            with obs.spans.start_span("sampling.spectrum"):
                spec = self.spectrum(cache, runtime=rt).to(dev)
            if k is not None:
                # exact-k draws cannot overflow their k-slot budget
                return _picks_to_subsets(sample_kdpp_batched(
                    key, spec, int(k), n, runtime=rt))
            if k_max is None:
                with obs.spans.start_span("sampling.k_max"):
                    k_max = spec.suggested_k_max()
            picks, _, truncated = sample_krondpp_batched(
                key, spec, int(k_max), n, runtime=rt)
            return _picks_to_subsets(picks, truncated)

    def _sample_host(self, key, n: int, device: torch.device
                     ) -> SubsetBatch:
        """n draws of the numpy oracle (``core.sampling``), seeded as the
        JAX package seeds it: ``randint(key, (), 0, int32 max)`` — so a
        key gives the JAX package's Host rows."""
        from ..core.sampling import sample_full_dpp, sample_krondpp
        rng = np.random.default_rng(_host_seed(key))
        if self.m == 1:
            L = self.dense_kernel()      # LowRank's behind the N x N guard
            subs = [sample_full_dpp(rng, L) for _ in range(n)]
        else:
            krondpp = KronDPP(tuple(self.factors))
            subs = [sample_krondpp(rng, krondpp) for _ in range(n)]
        k_max = max(1, max((len(s) for s in subs), default=1))
        return SubsetBatch.from_lists(subs, k_max=k_max, device=device)

    def service(self, **kwargs) -> SamplingService:
        """A micro-batching ``SamplingService`` over this model (submit /
        coalesce / one batched call / scatter); takes ``seed=``,
        ``k_max=``, ``max_batch=``, ``runtime=`` (a ``Mesh`` shards every
        flush), ``device=`` (default "cuda")."""
        return SamplingService(self, **kwargs)

    # -- likelihood ---------------------------------------------------------
    def log_prob(self, batch: SubsetBatch,
                 cache: Optional[SpectralCache] = None) -> torch.Tensor:
        """(n,) log P(Y_i) = log det(L_{Y_i}) - log det(L + I) for a padded
        subset batch, on the model's device (the batch is moved there):
        the subset log-determinants off the factors, the normalizer
        Σ logaddexp(log λ, 0) off the log-space product spectrum. The
        N x N kernel is never materialized."""
        from ..learning.objective import subset_logdets_factored
        dev = self.device
        batch = SubsetBatch(batch.indices.to(dev), batch.mask.to(dev))
        ll = self.spectrum(cache).log_eigenvalues()
        log_z = torch.logaddexp(ll, torch.zeros_like(ll)).sum()
        return subset_logdets_factored(self.factors, batch) - log_z

    def log_likelihood(self, batch: SubsetBatch,
                       cache: Optional[SpectralCache] = None
                       ) -> torch.Tensor:
        """Mean log P(Y_i) over the batch (the learners' objective phi)."""
        return self.log_prob(batch, cache).mean()

    # -- marginals ----------------------------------------------------------
    def marginal_kernel_submatrix(self, idx,
                                  cache: Optional[SpectralCache] = None
                                  ) -> torch.Tensor:
        """K[idx, idx] for the marginal kernel K = L(L+I)^{-1}, gathered
        from the factored spectrum in O(k² N) without forming K:
        K[a,b] = Σ_g σ(log λ_g) · Π_f P_f[a_f, g_f] P_f[b_f, g_f],
        contracted one factor at a time (the first factor's broadcast
        product is (k, k, N) floats). Indices are validated and
        deduplicated (set semantics)."""
        spec = self.spectrum(cache)
        idx = _as_index_set(idx, self.N, spec.device)
        parts = split_indices_multi(idx, spec.sizes)
        T = torch.sigmoid(spec.log_eigenvalues()).reshape(
            (1, 1) + spec.sizes)
        for V, p in zip(spec.vecs, parts):
            R = V[p, :]                          # (k, N_f)
            E = R[:, None, :] * R[None, :, :]    # (k, k, N_f)
            E = E.reshape(E.shape + (1,) * (T.ndim - 3))
            T = (E * T).sum(dim=2)               # contract factor f's axis
        return T

    def marginal(self, idx, cache: Optional[SpectralCache] = None
                 ) -> torch.Tensor:
        """P(idx ⊆ Y) = det(K_idx): a scalar index gives the singleton
        inclusion probability K_ii, an index set the joint inclusion
        probability (0-d tensor on the model's device)."""
        K_sub = self.marginal_kernel_submatrix(idx, cache)
        if K_sub.shape[0] == 1:
            return K_sub[0, 0]
        return torch.linalg.det(K_sub)

    # -- conditioning -------------------------------------------------------
    def condition(self, observed, max_dense: int = MAX_DENSE_N
                  ) -> "DPPModel":
        """The conditional DPP given ``observed ⊆ Y`` (Kulesza & Taskar
        closure): an L-ensemble over the complement ground set with the
        Schur-complement kernel L' = L_Ā - L_{Ā,A} L_A^{-1} L_{A,Ā}, as a
        ``Dense`` model on this model's device.

        Item i of the returned model is the i-th element of
        ``sorted(set(range(N)) - set(observed))``. An empty ``observed``
        returns ``self``. Kron kernels take the dense Schur complement
        behind the ``max_dense`` guard (the complement of a product index
        set is not a product set). Raises ``ValueError`` when L_A is
        singular (P(A ⊆ Y) = 0).
        """
        A = _as_index_set(observed, self.N, self.device)
        if A.numel() == 0:
            return self
        L = self.dense_kernel(max_dense)
        keep = torch.ones(self.N, dtype=torch.bool, device=L.device)
        keep[A] = False
        comp = torch.nonzero(keep).squeeze(1)
        L_cA = L[comp[:, None], A[None, :]]
        # torch.linalg.cholesky raises on a matrix that is not PD, where
        # jnp.linalg.cholesky returns NaN: cholesky_ex reports it in info
        chol, info = torch.linalg.cholesky_ex(L[A[:, None], A[None, :]])
        if int(info) != 0 or not bool(torch.isfinite(chol).all()):
            # det(L_A) = 0: P(A ⊆ Y) = 0, the conditional is undefined —
            # fail loudly instead of returning an all-NaN model
            raise ValueError(
                f"cannot condition on {observed!r}: L_A is singular "
                f"(P(A ⊆ Y) = 0 — e.g. linearly dependent items of a "
                f"rank-deficient kernel)")
        X = torch.cholesky_solve(L_cA.T, chol)  # L_A^{-1} L_{A,Ā}
        schur = L[comp[:, None], comp[None, :]] - L_cA @ X
        return Dense(0.5 * (schur + schur.T), device=L.device)

    # -- MAP ----------------------------------------------------------------
    def map(self, k: int, max_dense: int = MAX_DENSE_N) -> torch.Tensor:
        """Greedy MAP subset of size k (Chen et al. 2018 fast greedy,
        ``kernels.ops.greedy_map_kdpp``: one launch of the fused
        greedy-MAP kernel on the card) as (k,) int32 on the model's device. Kron kernels run on the
        dense materialization, guarded by ``max_dense``."""
        with obs.spans.start_span("dpp.map"):
            return kernel_ops.greedy_map_kdpp(self.dense_kernel(max_dense),
                                              int(k))

    # -- learning -----------------------------------------------------------
    def fit(self, batch: SubsetBatch, algorithm: Optional[str] = None,
            max_dense: int = MAX_DENSE_N, **fit_kwargs):
        """Maximum-likelihood fit through ``repro_torch.learning.fit``.
        Returns the engine's ``FitReport`` with ``report.model`` wrapped
        back into a facade model on the fit's device (``Kron`` for
        krk/joint, ``Dense`` for em). ``algorithm`` defaults to "em" for
        a ``Dense`` and "krk" for a ``Kron``. All engine kwargs (iters,
        schedule, minibatch_size, use_dense_theta, checkpoint_dir,
        save_every, resume, log_every, health, backend, device, ...) pass
        through; ``device`` defaults to "cuda";
        ``runtime=Mesh(...)`` runs krk / krk-stochastic sweeps sharded over
        the mesh (``core.distributed.ShardedStatistics``). ``max_dense``
        bounds the dense materialization a Kron model needs for
        ``algorithm="em"``."""
        from ..learning.api import fit as _fit
        if algorithm is None:
            algorithm = self._default_algorithm
        if algorithm == "lowrank":
            raise ValueError(
                f"algorithm='lowrank' learns a LowRank(V, q) model; a "
                f"{type(self).__name__} kernel learns with 'em' (Dense) or "
                f"'krk', 'krk-stochastic', 'joint', 'em' (Kron)")
        rep = _fit(self._fit_params(algorithm, max_dense), batch,
                   algorithm=algorithm, **fit_kwargs)
        if isinstance(rep.model, KronDPP):
            fitted = Kron(rep.model.factors,
                          device=rep.model.factors[0].device)
        else:
            fitted = Dense(rep.model, device=rep.model.device)
        return dataclasses.replace(rep, model=fitted)

    def serving(self, config=None, **kwargs):
        """The async continuous-batching tier over this model
        (``repro_torch.serving.AsyncSamplingService``): background
        deadline/max-batch flush thread, multi-tenant weighted-round-robin
        queues with admission control, futures tickets. Draws are keyed by
        (tenant, sequence number), so they are reproducible regardless of
        how the background thread coalesces traffic. Takes ``tenants=``,
        ``tenant_models=``, ``seed=``, ``k_max=``, ``cache=``,
        ``tracker=``, ``runtime=`` (handed to every tenant's engine),
        ``device=`` (default "cuda")."""
        from ..serving import AsyncSamplingService
        return AsyncSamplingService(self, config, **kwargs)

    # -- subclass hooks -----------------------------------------------------
    def _wrap_factors(self, factors: Tuple[torch.Tensor, ...]
                      ) -> "DPPModel":
        raise NotImplementedError

    def _fit_params(self, algorithm: str, max_dense: int = MAX_DENSE_N):
        raise NotImplementedError


class Dense(DPPModel):
    """An explicit N x N L-ensemble kernel behind the facade protocol."""

    _default_algorithm = "em"

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

    def _fit_params(self, algorithm: str, max_dense: int = MAX_DENSE_N):
        if algorithm != "em":
            raise ValueError(
                f"Dense kernels learn with algorithm='em'; {algorithm!r} "
                f"needs a factored Kron model")
        return self.L


class Kron(DPPModel):
    """The paper's Kronecker kernel L = L_1 ⊗ ... ⊗ L_m. ``factors`` may
    be tensors, numpy arrays or a ``core.KronDPP``; they are placed on
    ``device`` as float32."""

    _default_algorithm = "krk"

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

    def _wrap_factors(self, factors):
        return Kron(factors, device=self.device)

    def _fit_params(self, algorithm: str, max_dense: int = MAX_DENSE_N):
        if algorithm == "em":
            return self.dense_kernel(max_dense)
        return self._factors


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


def random_kron(key, sizes: Sequence[int], dtype: torch.dtype = FLOAT,
                scale: float = 1.0, *, device: DeviceLike = "cuda") -> Kron:
    """Paper Sec. 5.1 random init (L_i = X^T X + 1e-3 I,
    X ~ U[0, sqrt(2)]) from a PRNG key (the JAX package's factors for the
    same key) or a ``torch.Generator`` (``core.random_krondpp``); the
    arguments in the JAX package's order, ``device`` by keyword."""
    return Kron(random_krondpp(key, tuple(sizes), dtype, scale,
                               device=device), device=device)
