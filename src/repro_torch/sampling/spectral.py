"""Factor eigendecomposition cache (port of ``repro/sampling/spectral.py``).

Exact DPP sampling is two phases: a spectrum draw and a projection
selection loop. The only O(N_i^3) work is the per-factor ``eigh``, so
repeated sampling against one kernel pays for it once. The cache is keyed
on *factor identity* (not value): two KronDPPs that share a factor tensor
share its spectrum. Entries hold a strong reference to the keyed factor,
so an ``id()`` can never be recycled by a different live tensor while its
entry is cached.

``torch.linalg.eigh`` stays a library call (cuSOLVER on the card), as the
JAX package leaves ``eigh`` to XLA. The low-rank dual (``spectrum_lowrank``)
is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..core.krondpp import KronDPP


def log_product_spectrum(lams: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """log of the Kronecker product spectrum {prod_i lams[i][g_i]}, folded
    factor-wise in log space (row-major global order). A linear fold
    overflows float32 once eigenvalues multiply past ~3e38. Zero
    eigenvalues map to -inf (sigmoid -> 0)."""
    v = torch.log(lams[0])
    for lam in lams[1:]:
        v = (v[:, None] + torch.log(lam)[None, :]).reshape(-1)
    return v


@dataclasses.dataclass(frozen=True)
class FactorSpectrum:
    """Per-factor eigendecompositions of L = L_1 ⊗ ... ⊗ L_m.

    lams[i]: (N_i,) eigenvalues of factor i, clipped to >= 0, ascending.
    vecs[i]: (N_i, N_i) orthonormal eigenvectors (columns).
    """
    lams: Tuple[torch.Tensor, ...]
    vecs: Tuple[torch.Tensor, ...]

    @property
    def m(self) -> int:
        return len(self.lams)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(lam.shape[0]) for lam in self.lams)

    @property
    def N(self) -> int:
        return math.prod(self.sizes)

    @property
    def device(self) -> torch.device:
        return self.lams[0].device

    def to(self, device: DeviceLike) -> "FactorSpectrum":
        dev = resolve_device(device)
        return FactorSpectrum(tuple(lam.to(dev) for lam in self.lams),
                              tuple(v.to(dev) for v in self.vecs))

    def eigenvalues(self) -> torch.Tensor:
        """All N eigenvalues, row-major order. Reference only: overflows
        float32 for huge products; sampling uses ``log_eigenvalues``."""
        v = self.lams[0]
        for lam in self.lams[1:]:
            v = torch.outer(v, lam).reshape(-1)
        return v

    def log_eigenvalues(self) -> torch.Tensor:
        """log of the product spectrum (``log_product_spectrum``)."""
        return log_product_spectrum(self.lams)

    def expected_size(self) -> float:
        """E|Y| = sum λ/(1+λ) = sum sigmoid(log λ) — overflow-safe."""
        return float(torch.sigmoid(self.log_eigenvalues()).sum())

    def size_std(self) -> float:
        """sqrt(Var|Y|), Var|Y| = sum p(1-p) with p = λ/(1+λ)."""
        ll = self.log_eigenvalues()
        p = torch.sigmoid(ll)
        return float(torch.sqrt(torch.sum(p * torch.sigmoid(-ll))))

    def suggested_k_max(self, num_std: float = 6.0) -> int:
        """Static phase-2 budget: E|Y| + num_std·σ, clamped to [1, N]."""
        k = math.ceil(self.expected_size() + num_std * self.size_std()) + 1
        return max(1, min(k, self.N))


class _CacheStats(dict):
    """Counter snapshot that is also callable returning itself, so
    ``cache.stats["hits"]`` and ``cache.stats()`` read the same dict."""

    def __call__(self) -> "_CacheStats":
        return self


class SpectralCache:
    """LRU cache of per-factor eigendecompositions, keyed on tensor
    identity. ``spectrum(dpp)`` looks up each factor independently, so
    hits/misses count factor lookups (a 2-factor KronDPP costs two).

    Thread-safe: one lock guards the LRU map and the counters. A miss
    holds the lock across its ``eigh``, so concurrent lookups of the same
    factor decompose it once. Every lookup emits ``spectral_cache.hits`` /
    ``.misses`` / ``.evictions`` counters, and a miss a
    ``spectral_cache.eigh`` span and ``spectral_cache.eigh_s`` timer
    sample, through ``obs.current_tracker()``."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._entries = collections.OrderedDict()  #: guarded-by: _lock
        self.hits = 0                              #: guarded-by: _lock
        self.misses = 0                            #: guarded-by: _lock
        self.evictions = 0                         #: guarded-by: _lock
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def stats(self) -> "_CacheStats":
        """Factor-lookup hits/misses, LRU evictions and the entry count;
        usable as ``cache.stats()`` and as ``cache.stats["hits"]``."""
        with self._lock:
            return _CacheStats(hits=self.hits, misses=self.misses,
                               evictions=self.evictions,
                               size=len(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def _factor(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tracker = obs.current_tracker()
        key = (id(f), tuple(f.shape), str(f.dtype), str(f.device))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                tracker.counter("spectral_cache.hits")
                self._entries.move_to_end(key)
                return hit[1], hit[2]
            self.misses += 1
            tracker.counter("spectral_cache.misses")
            if obs.enabled(tracker):
                # the synchronize exists only to make the eigh timer an
                # honest wall-clock sample; the NullTracker path keeps
                # PyTorch's asynchronous launch
                with obs.spans.start_span("spectral_cache.eigh",
                                          tracker=tracker,
                                          n=int(f.shape[0])):
                    with tracker.timer("spectral_cache.eigh_s",
                                       n=int(f.shape[0])):
                        lam, vec = torch.linalg.eigh(f)
                        if f.is_cuda:
                            torch.cuda.synchronize(f.device)
            else:
                lam, vec = torch.linalg.eigh(f)
            lam = torch.clamp_min(lam, 0.0)
            self._entries[key] = (f, lam, vec)   # strong ref pins the id
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                tracker.counter("spectral_cache.evictions")
            return lam, vec

    def spectrum(self, dpp) -> FactorSpectrum:
        """FactorSpectrum for anything with ``factors`` (a ``KronDPP`` or
        a facade model; a dense kernel is the m=1 case) — O(sum N_i^3) on
        miss, O(1) on hit."""
        pairs = [self._factor(f) for f in dpp.factors]
        return FactorSpectrum(tuple(p[0] for p in pairs),
                              tuple(p[1] for p in pairs))


def gain_for_expected_size(log_lams, target: float,
                           iters: int = 100) -> float:
    """Scalar gain g such that E|Y| = Σ σ(log g + log λ) hits ``target`` —
    bisection on log g over the log-space product spectrum, in float64
    numpy on the host.

    Raises ``ValueError`` when ``target`` is outside the achievable open
    range (0, rank): E|Y| tends to 0 as g -> 0 and to the number of
    nonzero eigenvalues as g -> ∞, never reaching either end."""
    if isinstance(log_lams, torch.Tensor):
        log_lams = log_lams.detach().cpu().numpy()
    ll = np.asarray(log_lams, np.float64)
    rank = int(np.isfinite(ll).sum())         # log λ = -inf for zero eigs
    target = float(target)
    if not np.isfinite(target) or target <= 0.0 or target >= rank:
        raise ValueError(
            f"target expected size {target} is not achievable: E|Y| = "
            f"Σ λ/(1+λ) of this spectrum is confined to the open interval "
            f"(0, {rank}) (rank = number of nonzero eigenvalues, "
            f"N = {ll.size}); rescale to a size strictly inside it")
    lo, hi = -60.0, 60.0                      # g in [~1e-26, ~1e26]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        e = (1.0 / (1.0 + np.exp(-(ll + mid)))).sum()
        if e > target:
            hi = mid
        else:
            lo = mid
    return float(np.exp(0.5 * (lo + hi)))


def rescale_expected_size(dpp: KronDPP, target: float,
                          iters: int = 100) -> KronDPP:
    """Scalar-rescale the factors so E|Y| hits ``target``; raises
    ``ValueError`` (``gain_for_expected_size``) outside (0, rank)."""
    lams = tuple(torch.clamp_min(torch.linalg.eigvalsh(f), 0.0)
                 for f in dpp.factors)
    g = gain_for_expected_size(log_product_spectrum(lams), target, iters)
    return KronDPP(tuple(f * (g ** (1.0 / dpp.m)) for f in dpp.factors))


_DEFAULT_CACHE: Optional[SpectralCache] = None


def default_cache() -> SpectralCache:
    """Process-wide cache shared by the convenience entry points."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = SpectralCache()
    return _DEFAULT_CACHE
