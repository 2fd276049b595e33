"""Exact k-DPP sampling of the PyTorch port against the JAX package.

Both packages draw from the same spectrum (the JAX eigendecomposition,
carried across with ``repro_torch.convert``) and the same uniforms, drawn
here exactly as JAX's ``_phase1_one_kdpp`` draws them: per row key,
``k1, k2 = split(key)``, ``u = uniform(k1, (N,))``, ``us = uniform(k2,
(k,))``. Phase-1 masks must be equal; picks equal up to a named
CDF-boundary tie (``test_torch_phase2.assert_same_picks``), phase 2 plain.
The port's generator-driven entry points (``sample_kdpp_batched``,
``model.sample(k=)``) and the seeded ``svc.sample_kdpp`` are held to
``sample_kdpp_from_uniforms`` on the uniforms their generator or key
gives, so they inherit that draw-for-draw agreement. The ESP table: rtol 1e-5
against JAX (the same recursion, float32, transcendentals from other
libraries) and, as in tests/test_sampling_batched.py, rtol 1e-4 / atol
1e-7 against brute force. Distributions: ±0.04 at 4000 draws, as there.
"""

import itertools
import os
from collections import Counter

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KronDPP, random_krondpp
from repro.sampling import SpectralCache
from repro.sampling.kdpp import _phase1_kdpp as jax_phase1
from repro.sampling.kdpp import log_esp_table as jax_log_esp_table
from repro.sampling.kdpp import sample_kdpp_batched as jax_sample_kdpp
import repro_torch.obs as obs
from repro_torch import dpp
from repro_torch import random as prng
from repro_torch.convert import spectrum_from_numpy
from repro_torch.kernels.phase2_select import canonical_pair
from repro_torch.sampling import SamplingService, picks_to_lists
from repro_torch.sampling import kdpp as tk
from repro_torch.sampling.batched import gather_factor_columns
from repro_torch.sampling.batched import compact_selection, keyed_uniforms
from test_torch_phase2 import assert_rows_distinct, assert_same_picks


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def carried(spec):
    return spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                               [np.asarray(x) for x in spec.vecs],
                               device="cpu")


def jax_uniforms(key, B, N, k):
    keys = jax.random.split(key, B)
    k1, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (N,)))(k1)
    us = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(k2)
    return k1, u, us


def test_log_esp_table_matches_jax_and_bruteforce():
    rng = np.random.default_rng(0)
    lam = np.abs(rng.standard_normal(10)).astype(np.float32)
    lam[4] = 0.0                                    # a -inf log eigenvalue
    with np.errstate(divide="ignore"):
        ll = np.log(lam)
    tab = tk.log_esp_table(torch.from_numpy(ll), 4).numpy()
    want = np.asarray(jax_log_esp_table(jnp.asarray(ll), 4))
    assert tab.shape == (11, 5)
    np.testing.assert_array_equal(np.isfinite(tab), np.isfinite(want))
    np.testing.assert_allclose(tab[np.isfinite(tab)],
                               want[np.isfinite(want)], rtol=1e-5, atol=1e-6)
    for n in range(11):
        for j in range(5):
            exact = sum(np.prod(c, dtype=np.float64) for c in
                        itertools.combinations(lam[:n], j)) if j else 1.0
            np.testing.assert_allclose(np.exp(tab[n, j]), exact, rtol=1e-4,
                                       atol=1e-7)


@pytest.mark.parametrize("k", [1, 3, 6, 8, 11])
def test_phase1_matches_jax_on_its_uniforms(k):
    """Draw for draw, including the below-rank clamp: the (4, 3) kernel
    has rank 8 of 12, so k = 11 sets exactly 8 entries per row."""
    L1 = np.diag([2.0, 1.0, 0.7, 0.0]).astype(np.float32)
    L2 = np.asarray([[1.5, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.0]],
                    np.float32)
    spec = SpectralCache().spectrum(KronDPP((jnp.asarray(L1),
                                             jnp.asarray(L2))))
    ll = np.asarray(spec.log_eigenvalues())
    rank = int(np.isfinite(ll).sum())
    k1, u, _ = jax_uniforms(jax.random.PRNGKey(k), 40, spec.N, k)
    want = np.asarray(jax.vmap(
        lambda kk: jax_phase1(kk, jnp.asarray(ll), k))(k1))
    got = tk._phase1_kdpp_from_uniforms(t(u), t(ll), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(dim=1) == min(k, rank)).all()
    one = tk._phase1_kdpp_from_uniforms(t(u[0]), t(ll), k)
    np.testing.assert_array_equal(one.numpy(), want[0])


@pytest.mark.parametrize("sizes,k,seed", [((3, 4), 3, 0), ((6, 5), 5, 1),
                                          ((2, 3, 2), 4, 2), ((12,), 2, 3)])
def test_sample_kdpp_matches_jax_on_shared_uniforms(sizes, k, seed):
    m = random_krondpp(jax.random.PRNGKey(seed), sizes)
    spec = SpectralCache().spectrum(m)
    tspec = carried(spec)
    B, N = 24, spec.N
    key = jax.random.PRNGKey(100 + seed)
    _, u, us = jax_uniforms(key, B, N, k)
    want = np.asarray(jax_sample_kdpp(key, spec, k, B, backend="reference"))
    got = tk.sample_kdpp_from_uniforms(t(u), t(us), tspec, k)
    assert got.dtype == torch.int32 and got.shape == (B, k)
    mask = tk._phase1_kdpp_from_uniforms(t(u), tspec.log_eigenvalues(), k)
    sel, valid, _ = compact_selection(mask, k)
    G1, Gr = canonical_pair(gather_factor_columns(tspec.vecs, tspec.sizes,
                                                  sel, valid))
    assert_same_picks(want, got.numpy(), t(us), G1, Gr,
                      f"k-DPP sizes={sizes} k={k}")
    assert_rows_distinct(got)
    assert (got >= 0).all()                    # full rank: exactly k items


def test_generator_entry_points_use_their_uniforms():
    """``sample_kdpp_batched`` and ``model.sample(k=)`` given a generator
    are ``sample_kdpp_from_uniforms`` on its uniforms (u (B, N) first,
    then us (B, k)); the seeded ``svc.sample_kdpp`` is the same on the
    uniforms of its key (``key, sub = split(key)``, one key per row from
    ``split(sub, B)``, drawn as JAX draws them) — so all match JAX draw
    for draw wherever the test above does."""
    factors = [np.asarray(f) for f in
               random_krondpp(jax.random.PRNGKey(4), (3, 4)).factors]
    model = dpp.Kron(factors, device="cpu")
    spec = model.spectrum()
    k, B = 3, 16

    def replay(seed, batch):
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand((batch, spec.N), generator=gen)
        us = torch.rand((batch, k), generator=gen)
        return tk.sample_kdpp_from_uniforms(u, us, spec, k)

    def replay_key(seed, batch):
        _, sub = prng.split(prng.PRNGKey(seed, "cpu"))
        u, us = keyed_uniforms(prng.split(sub, batch), spec.N, k)
        return tk.sample_kdpp_from_uniforms(u, us, spec, k)

    got = tk.sample_kdpp_batched(torch.Generator().manual_seed(7), spec, k, B)
    assert torch.equal(got, replay(7, B))
    batch = model.sample(torch.Generator().manual_seed(8), B, k=k,
                         device="cpu")
    assert batch.truncated is None and (batch.sizes() == k).all()
    assert torch.equal(batch.indices, replay(8, B))
    svc = model.service(seed=9, device="cpu")
    assert svc.sample_kdpp(k, B) == picks_to_lists(replay_key(9, B))


def test_kdpp_exactly_k_and_conditional_distribution():
    """Mirror of tests/test_sampling_batched.py: exactly k distinct items
    per row, subset frequencies within 0.04 of det(L_Y) / Σ det."""
    m = random_krondpp(jax.random.PRNGKey(3), (2, 3))
    L = np.asarray(m.full_matrix(), np.float64)
    k, S = 2, 4000
    dets = {Y: np.linalg.det(L[np.ix_(Y, Y)])
            for Y in itertools.combinations(range(6), k)}
    Z = sum(dets.values())
    spec = carried(SpectralCache().spectrum(m))
    picks = tk.sample_kdpp_batched(torch.Generator().manual_seed(9), spec, k,
                                   S)
    rows = picks_to_lists(picks)
    assert all(len(set(r)) == k for r in rows)
    cnt = Counter(tuple(sorted(r)) for r in rows)
    for Y, d in dets.items():
        assert abs(cnt.get(Y, 0) / S - d / Z) < 0.04, Y


def test_kdpp_below_rank_pads_with_minus_one():
    """Mirror of tests/test_phase2_fused.py: rank 6 of 12, k = 8 gives
    exactly 6 distinct items and a -1 tail; k = rank gives k items."""
    L1 = np.diag([2.0, 1.0, 0.0, 0.0]).astype(np.float32)
    L2 = np.diag([3.0, 1.5, 0.5]).astype(np.float32)
    m = dpp.Kron((L1, L2), device="cpu")
    spec = m.spectrum()
    picks = tk.sample_kdpp_batched(torch.Generator().manual_seed(0), spec, 8,
                                   32).numpy()
    assert picks.shape == (32, 8)
    for row in picks:
        real = row[row >= 0]
        assert len(real) == 6
        assert len(set(real.tolist())) == 6
        assert (row[6:] == -1).all()
    picks = tk.sample_kdpp_batched(torch.Generator().manual_seed(1), spec, 6,
                                   16)
    assert (picks >= 0).all()
    assert_rows_distinct(picks)
    batch = m.sample(torch.Generator().manual_seed(2), 5, k=8, device="cpu")
    assert (batch.sizes() == 6).all()


@pytest.mark.parametrize("kind", ["dense", "kron"])
def test_kdpp_sample_exactly_k(kind):
    """Mirror of tests/test_dpp_facade.py::test_kdpp_sample_exactly_k."""
    m = dpp.random_kron(torch.Generator().manual_seed(5), (2, 3),
                        device="cpu")
    if kind == "dense":
        m = dpp.from_kernel(m.dense_kernel(), device="cpu")
    batch = m.sample(torch.Generator().manual_seed(1), 200, k=2,
                     device="cpu")
    assert batch.n == 200 and (batch.sizes() == 2).all()
    assert all(len(set(row)) == 2 for row in batch.to_lists())


def test_service_kdpp_exact_k_and_metrics():
    """Mirror of tests/test_sampling_batched.py::test_service_kdpp_exact_k,
    plus the chunking at max_batch and the service counters."""
    m = dpp.random_kron(torch.Generator().manual_seed(0), (3, 4),
                        device="cpu")
    svc = SamplingService(m, seed=1, max_batch=4, device="cpu")
    with obs.use(obs.InMemoryTracker()) as tr:
        rows = svc.sample_kdpp(3, num_samples=5)
    assert len(rows) == 5 and all(len(set(r)) == 3 for r in rows)
    assert svc.stats.device_calls == 2 and svc.stats.samples_drawn == 8
    assert tr.counter_value("kernels.phase2_select.reference") == 2
    assert len(tr.observations["service.device_call_s"]) == 2


def test_sample_kdpp_dense_and_functional():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((12, 4)).astype(np.float32)
    L = torch.from_numpy(X @ X.T + 1e-3 * np.eye(12, dtype=np.float32))
    picks = dpp.functional.sample_kdpp_dense(
        torch.Generator().manual_seed(3), L, 4)
    assert picks.shape == (4,) and picks.dtype == torch.int32
    assert len(set(picks.tolist())) == 4
    assert (picks >= 0).all() and (picks < 12).all()
    assert dpp.functional.sample_kdpp_batched is tk.sample_kdpp_batched
    assert dpp.functional.sample_kdpp_dense is tk.sample_kdpp_dense
