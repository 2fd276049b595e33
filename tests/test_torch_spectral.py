"""Spectral layer of the PyTorch port against the JAX package:
``log_product_spectrum``, ``FactorSpectrum`` sizes, ``gain_for_expected_size``
and rescaling at rtol 1e-5 (float32 sums in other orders), ``eigh`` by
eigenvalues (1e-5 of the factor's norm) and sign-invariant projectors
(atol 1e-4) — never
raw eigenvector columns — and the ``SpectralCache`` contract."""

import os

# the JAX reference runs on the CPU, never on the card
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import random_krondpp
from repro.dpp import Kron as JaxKron
from repro.sampling import SpectralCache as JaxCache
from repro.sampling.spectral import \
    gain_for_expected_size as jax_gain
from repro.sampling.spectral import \
    log_product_spectrum as jax_lps
from repro_torch import obs
from repro_torch.convert import kron_from_numpy, spectrum_from_numpy
from repro_torch.core import KronDPP, random_krondpp as t_random_krondpp
from repro_torch.sampling.spectral import (SpectralCache,
                                           gain_for_expected_size,
                                           log_product_spectrum,
                                           rescale_expected_size)


def np_factors(m):
    return [np.asarray(f) for f in m.factors]


def test_log_product_spectrum_matches_including_zero_eigenvalues():
    lams = (jnp.asarray([0.0, 0.5, 2.0, 7.0]), jnp.asarray([1e-3, 3.0, 0.0]))
    want = np.asarray(jax_lps(lams))
    got = log_product_spectrum(tuple(torch.tensor(np.asarray(x))
                                     for x in lams)).numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("sizes", [(3, 4), (20, 25), (4, 3, 5)])
def test_spectrum_sizes_match(sizes):
    m = random_krondpp(jax.random.PRNGKey(1), sizes)
    spec = JaxCache().spectrum(m)
    tspec = spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                                [np.asarray(x) for x in spec.vecs],
                                device="cpu")
    assert tspec.sizes == spec.sizes and tspec.N == spec.N
    np.testing.assert_allclose(tspec.expected_size(), spec.expected_size(),
                               rtol=1e-5)
    np.testing.assert_allclose(tspec.size_std(), spec.size_std(), rtol=1e-5)
    assert tspec.suggested_k_max() == spec.suggested_k_max()
    np.testing.assert_allclose(tspec.eigenvalues().numpy(),
                               np.asarray(spec.eigenvalues()), rtol=1e-5)


def test_eigh_parity_eigenvalues_and_projectors():
    """The port's own eigh (the cache's) against JAX's on the same
    factors: eigenvalues, and each eigenvector's projector v vᵀ.

    Eigenvalues compare at rtol 1e-5 of the factor's norm (its largest
    eigenvalue): a backward-stable float32 eigh perturbs every eigenvalue
    by up to about eps·‖L‖, so a small eigenvalue cannot agree to 1e-5 of
    itself between LAPACK builds."""
    m = random_krondpp(jax.random.PRNGKey(3), (6, 9))
    spec = JaxCache().spectrum(m)
    tspec = SpectralCache().spectrum(kron_from_numpy(np_factors(m),
                                                     device="cpu"))
    for lam, vec, tlam, tvec in zip(spec.lams, spec.vecs, tspec.lams,
                                    tspec.vecs):
        scale = float(np.abs(np.asarray(lam)).max())
        np.testing.assert_allclose(tlam.numpy(), np.asarray(lam), rtol=1e-5,
                                   atol=1e-5 * scale)
        V, Vt = np.asarray(vec), tvec.numpy()
        P = np.einsum("ic,jc->cij", V, V)
        Pt = np.einsum("ic,jc->cij", Vt, Vt)
        np.testing.assert_allclose(Pt, P, atol=1e-4)


def test_gain_rejects_unachievable_targets_and_matches_jax():
    log_lams = np.log(np.asarray([4.0, 2.0, 1.0, 0.5], np.float32))
    for bad in (0.0, -1.0, 4.0, 7.5, float("nan")):
        with pytest.raises(ValueError, match="not achievable"):
            gain_for_expected_size(torch.tensor(log_lams), bad)
    for target in (0.3, 2.0, 3.7):
        np.testing.assert_allclose(
            gain_for_expected_size(torch.tensor(log_lams), target),
            jax_gain(jnp.asarray(log_lams), target), rtol=1e-5)
    rank_def = torch.log(torch.tensor([4.0, 2.0, 0.0, 0.0]))
    with pytest.raises(ValueError, match="not achievable"):
        gain_for_expected_size(rank_def, 2.0)           # rank 2 < N 4
    dpp = t_random_krondpp(torch.Generator().manual_seed(0), (3, 4),
                           device="cpu")
    with pytest.raises(ValueError, match="not achievable"):
        rescale_expected_size(dpp, 12.0)                # target == N


def test_rescale_matches_jax():
    m = random_krondpp(jax.random.PRNGKey(2), (5, 6))
    want = JaxKron(m.factors).rescale(5.0)
    got = kron_from_numpy(np_factors(m), device="cpu").rescale(5.0)
    for f, ft in zip(want.factors, got.factors):
        np.testing.assert_allclose(ft.numpy(), np.asarray(f), rtol=1e-5)
    assert abs(got.expected_size() - 5.0) < 1e-3
    with pytest.raises(ValueError, match="not achievable"):
        got.rescale(0.0)
    rescaled = rescale_expected_size(got.to_krondpp(), 7.0)
    assert abs(SpectralCache().spectrum(rescaled).expected_size() - 7.0) \
        < 1e-3


def test_spectral_cache_hit_miss_and_eviction():
    gen = torch.Generator().manual_seed(0)
    cache = SpectralCache(maxsize=3)
    m1 = t_random_krondpp(gen, (3, 4), device="cpu")
    m2 = t_random_krondpp(gen, (3, 4), device="cpu")
    cache.spectrum(m1)
    assert cache.stats() == {"hits": 0, "misses": 2, "evictions": 0,
                             "size": 2}
    assert cache.stats["misses"] == 2
    cache.spectrum(m1)
    assert cache.stats()["hits"] == 2 and cache.stats()["misses"] == 2
    cache.spectrum(m2)                       # 2 more misses, evicts one
    assert cache.stats()["misses"] == 4 and len(cache) == 3
    assert cache.stats()["evictions"] == 1
    m3 = KronDPP((m2.factors[0], m1.factors[1]))
    cache.spectrum(m3)
    assert cache.stats()["hits"] == 4 and cache.stats()["misses"] == 4


def test_spectral_cache_emits_counters_and_eigh_span():
    gen = torch.Generator().manual_seed(1)
    m = t_random_krondpp(gen, (3, 5), device="cpu")
    cache = SpectralCache()
    with obs.use(obs.InMemoryTracker()) as tr:
        cache.spectrum(m)
        cache.spectrum(m)
    assert tr.counters == {"spectral_cache.misses": 2,
                           "spectral_cache.hits": 2}
    assert len(tr.observations["spectral_cache.eigh_s"]) == 2
    ops = [e["op"] for e in tr.events if e["name"] == "span"]
    assert ops == ["spectral_cache.eigh", "spectral_cache.eigh"]


def test_kron_algebra_matches_jax():
    """core.kron: the dense product, the vec-trick matvec (single and
    batched) and the row-major index split, against the JAX package."""
    from repro.core import kron as jk
    from repro_torch.core import kron as tk
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 4)).astype(np.float32)
    B = rng.standard_normal((5, 2)).astype(np.float32)
    x = rng.standard_normal((7, 8)).astype(np.float32)
    np.testing.assert_allclose(tk.kron(torch.tensor(A), torch.tensor(B)),
                               np.asarray(jk.kron(A, B)), rtol=1e-6)
    np.testing.assert_allclose(
        tk.kron_matvec(torch.tensor(A), torch.tensor(B), torch.tensor(x)),
        np.asarray(jk.kron_matvec(A, B, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tk.kron_matvec(torch.tensor(A), torch.tensor(B), torch.tensor(x[0])),
        np.kron(A, B) @ x[0], rtol=1e-5, atol=1e-5)
    idx = np.arange(60, dtype=np.int32)
    want = jk.split_indices_multi(jnp.asarray(idx), (3, 4, 5))
    got = tk.split_indices_multi(torch.tensor(idx), (3, 4, 5))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
