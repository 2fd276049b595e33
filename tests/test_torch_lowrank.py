"""The low-rank family of the PyTorch port (``repro_torch.lowrank``,
``dpp.LowRank``) against the JAX package's ``repro.lowrank``.

The same numpy inputs go through both packages on the CPU in float32; a
model's dual eigenvectors W are carried across (``convert``), since eigh
sign and degenerate-basis choices differ between LAPACK builds. Tolerances:

* the dual spectrum: eigenvalues rtol 1e-5 (atol 1e-6 of max λ),
  sign-invariant projectors W·diag(f(λ))·Wᵀ 1e-5 of their max, φ equal to
  float32 roundoff;
* keyed draws, DPP and k-DPP: uniforms bit for bit, picks equal row for
  row, except a row whose phase-1 uniform lies within 1e-6 of its
  threshold (the packages round sigmoid(log λ) apart; a different draw,
  not compared) or a proven float32 tie on the exact chain
  (``kernels.phase2_select.first_difference`` on U = φΓ in float64);
* ``log_prob`` within 1e-4·max(1, |ref|) on the support; beyond the rank
  -inf or float32 noise below -8 in both packages (the det is 0);
  ``marginal_kernel_submatrix`` atol 1e-5; ``condition``'s V within
  1e-4·max|φ|; ``map`` picks equal up to the rank;
* ``fit_lowrank``, 3 sweeps: LLs rtol 1e-4, V and q within 1e-3 of their
  max (float32 gradients of ``slogdet`` in other orders);
* the feature maps: the same arrays (the same numpy code).

Sizes: N <= 256, r <= 16, n <= 64 subsets."""

import os
import tempfile
import warnings

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dpp as jdpp
from repro import obs as jax_obs
from repro.core import random_krondpp as jax_random_krondpp
from repro.learning import schedules as jax_schedules
from repro.lowrank import features as jax_features
from repro.lowrank.learn import fit_lowrank as jax_fit_lowrank
from repro.sampling import SpectralCache as JaxCache
from repro_torch import dpp, obs
from repro_torch import random as tr
from repro_torch.convert import (dual_spectrum_from_numpy,
                                  dual_spectrum_to_numpy, key_from_numpy,
                                  kron_from_numpy, lowrank_from_numpy,
                                  subset_batch_from_numpy)
from repro_torch.core import SubsetBatch
from repro_torch.core.dpp import enumerate_probabilities, marginal_kernel
from repro_torch.kernels.phase2_select import (first_difference,
                                               is_roundoff_tie)
from repro_torch.learning import fit, schedules
from repro_torch.lowrank import features
from repro_torch.lowrank.learn import fit_lowrank
from repro_torch.lowrank.sample import (_gamma, sample_dual_keyed,
                                        sample_dual_kdpp_keyed)
from repro_torch.sampling import (SamplingService, SpectralCache,
                                  compact_selection, sample_kdpp_batched,
                                  sample_krondpp_batched,
                                  sample_krondpp_keyed)
from repro_torch.sampling.batched import keyed_uniforms
from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms

TIE = 1e-6          # a uniform this close to its threshold may flip a mask
LOGP_RTOL = 1e-4
LL_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_REL = 1e-3


def np_(x):
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def inputs(N, r, seed, qscale=1.0):
    """V ~ 0.7·N(0, 1), q = |N(0, 1)| + 0.3 (the JAX benchmark's family),
    float32 numpy."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(N, r)) * 0.7).astype(np.float32)
    q = ((np.abs(rng.normal(size=N)) + 0.3) * qscale).astype(np.float32)
    return V, q


class Carried:
    """A spectral cache that hands out a carried dual spectrum."""

    def __init__(self, spec):
        self.spec = spec

    def spectrum_lowrank(self, V, q):
        return self.spec.phi, self.spec.lams, self.spec.W


def pair(N=64, r=6, seed=0, target=3.0):
    """The JAX model rescaled to E|Y| = target, its spectrum, the port's
    model on the same (V, q) and the carried spectrum."""
    V, q = inputs(N, r, seed)
    jm = jdpp.LowRank(jnp.asarray(V), jnp.asarray(q))
    if target is not None:
        jm = jm.rescale(target, JaxCache())
    jspec = jm.spectrum(JaxCache())
    tm = lowrank_from_numpy(np_(jm.V), np_(jm.q), device="cpu")
    tspec = dual_spectrum_from_numpy(*dual_spectrum_to_numpy(jspec),
                                     device="cpu")
    return jm, jspec, tm, tspec


def jax_row_uniforms(keys, n, k):
    keys = jnp.asarray(keys, jnp.uint32)
    k1, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
    return (np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))(k1)),
            np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(k2)))


def assert_dual_rows_match(want, got, row_keys, jspec, tspec, k, kdpp=False):
    """``want`` (JAX) and ``got`` (port) picks (B, k) drawn from
    ``row_keys`` (B, 2) on the same dual spectrum, under the module's rule.
    Returns the number of rows compared."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    u, us = keyed_uniforms(tr.as_key(row_keys, "cpu"), tspec.rank, k)
    ju, jus = jax_row_uniforms(row_keys, tspec.rank, k)
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  ju.view(np.uint32))
    np.testing.assert_array_equal(us.numpy().view(np.uint32),
                                  jus.view(np.uint32))
    ll = tspec.log_eigenvalues()
    if kdpp:
        mask = _phase1_kdpp_from_uniforms(u, ll, k)
        near = np.zeros(len(want), bool)
    else:
        p_t = torch.sigmoid(ll).numpy()
        p_j = np.asarray(jax.nn.sigmoid(jspec.log_eigenvalues()))
        mask = u < torch.sigmoid(ll)[None, :]
        near = (np.minimum(np.abs(u.numpy() - p_t), np.abs(u.numpy() - p_j))
                <= TIE).any(axis=1)
    sel, valid, _ = compact_selection(mask, k)
    Gamma = _gamma(tspec.basis(), sel, valid).double()
    phi = tspec.phi.double()
    ones = torch.ones((1, k), dtype=torch.float64)
    compared = 0
    for b in range(len(want)):
        if near[b]:
            continue
        compared += 1
        if (want[b] == got[b]).all():
            continue
        step, kind, value = first_difference(us[b], phi @ Gamma[b], ones,
                                             want[b], got[b])
        assert is_roundoff_tie(kind, value), (
            f"row {b} differs at step {step}: {want[b]} vs {got[b]} "
            f"({kind} {value}) — not a roundoff tie")
        warnings.warn(f"row {b} differs at step {step} on a roundoff tie")
    assert compared >= len(want) // 2
    return compared


def assert_rows_valid(picks, N, k_max):
    for row in np.asarray(picks):
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real) <= k_max
        assert ((real >= 0) & (real < N)).all()
        assert (row[len(real):] == -1).all()       # -1 padding at the end


# ---------------------------------------------------------------------------
# the dual spectrum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,r,seed", [(10, 4, 0), (64, 6, 1), (256, 16, 2),
                                      (5, 8, 3)])
def test_dual_spectrum_matches_jax(N, r, seed):
    """Eigenvalues, φ and sign-invariant projectors of the port's own eigh
    against the JAX package's (r > N gives zero dual eigenvalues)."""
    V, q = inputs(N, r, seed)
    js = jdpp.LowRank(jnp.asarray(V), jnp.asarray(q)).spectrum(JaxCache())
    ts = dpp.LowRank(V, q, device="cpu").spectrum(SpectralCache())
    assert isinstance(ts, dpp.DualSpectrum)
    assert (ts.N, ts.rank) == (js.N, js.rank) == (N, r)
    lj, lt = np_(js.lams), np_(ts.lams)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6 * lj.max())
    np.testing.assert_allclose(np_(ts.phi), np_(js.phi), rtol=1e-6,
                               atol=1e-7)
    for f in (lambda x: x, lambda x: 1.0 / (1.0 + x)):
        Pj = (np_(js.W) * f(lj)) @ np_(js.W).T
        Pt = (np_(ts.W) * f(lt)) @ np_(ts.W).T
        np.testing.assert_allclose(Pt, Pj, atol=1e-5 * np.abs(Pj).max())
    assert (lt >= 0).all()


@pytest.mark.parametrize("N,r,seed,target", [(64, 6, 0, 3.0),
                                             (200, 16, 1, 8.0),
                                             (12, 3, 2, 2.5)])
def test_sizes_budget_and_rescale_match_jax(N, r, seed, target):
    V, q = inputs(N, r, seed)
    jm = jdpp.LowRank(jnp.asarray(V), jnp.asarray(q))
    tm = dpp.LowRank(V, q, device="cpu")
    js, ts = jm.spectrum(JaxCache()), tm.spectrum(SpectralCache())
    assert ts.suggested_k_max() == js.suggested_k_max()
    assert 1 <= ts.suggested_k_max() <= r
    np.testing.assert_allclose(ts.expected_size(), js.expected_size(),
                               rtol=1e-5)
    np.testing.assert_allclose(ts.size_std(), js.size_std(), rtol=1e-5)
    jr, tr_ = jm.rescale(target, JaxCache()), tm.rescale(target,
                                                          SpectralCache())
    assert type(tr_) is dpp.LowRank and tr_.V is tm.V
    np.testing.assert_allclose(np_(tr_.q), np_(jr.q), rtol=1e-5)
    np.testing.assert_allclose(tr_.expected_size(SpectralCache()), target,
                               atol=1e-3)
    for bad in (0.0, float(r), r + 0.5):          # E|Y| lives in (0, r)
        with pytest.raises(ValueError, match="not achievable"):
            tm.rescale(bad, SpectralCache())


def test_basis_zeroes_zero_eigenvalue_columns():
    V, q = inputs(5, 8, 0)                       # rank 5 of r = 8
    ts = dpp.LowRank(V, q, device="cpu").spectrum(SpectralCache())
    js = jdpp.LowRank(jnp.asarray(V), jnp.asarray(q)).spectrum(JaxCache())
    carried = dual_spectrum_from_numpy(*dual_spectrum_to_numpy(js),
                                       device="cpu")
    np.testing.assert_allclose(np_(carried.basis()), np_(js.basis()),
                               rtol=1e-6, atol=1e-7)
    E = np_(ts.basis())
    assert np.isfinite(E).all()
    assert (E[:, np_(ts.lams) == 0.0] == 0.0).all()
    assert np.isneginf(np_(ts.log_eigenvalues())[np_(ts.lams) == 0]).all()


# ---------------------------------------------------------------------------
# keyed draws against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,r,seed,target", [(64, 6, 0, 3.0),
                                             (256, 16, 1, 6.0),
                                             (20, 5, 2, 4.5)])
def test_keyed_dpp_draws_match_jax(N, r, seed, target):
    """``model.sample(key, 48)`` draw for draw, through the facade and
    ``sample_krondpp_batched``'s hook, with W carried across."""
    jm, jspec, tm, tspec = pair(N, r, seed, target)
    key = jax.random.PRNGKey(10 + seed)
    want = jm.sample(key, 48)
    got = tm.sample(key_from_numpy(np.asarray(key), "cpu"), 48,
                    cache=Carried(tspec), device="cpu")
    assert got.indices.dtype == torch.int32
    k_max = jspec.suggested_k_max()
    assert got.k_max == k_max
    keys = np.asarray(jax.random.split(key, 48))
    want_p = np.where(np.asarray(want.mask), np.asarray(want.indices), -1)
    got_p = np.where(got.mask.numpy(), got.indices.numpy(), -1)
    assert_dual_rows_match(want_p, got_p, keys, jspec, tspec, k_max)
    np.testing.assert_array_equal(got.truncated.numpy(),
                                  np.asarray(want.truncated))
    assert_rows_valid(got_p, N, min(r, k_max))


@pytest.mark.parametrize("N,r,seed,k", [(64, 6, 0, 3), (256, 16, 1, 7),
                                        (20, 5, 2, 5), (12, 3, 3, 5)])
def test_keyed_kdpp_draws_match_jax(N, r, seed, k):
    """``model.sample(key, 48, k=)`` draw for draw; exactly min(k, rank)
    distinct items a row (k > r pads with -1)."""
    jm, jspec, tm, tspec = pair(N, r, seed, None)
    key = jax.random.PRNGKey(20 + seed)
    want = jm.sample(key, 48, k=k)
    got = tm.sample(key_from_numpy(np.asarray(key), "cpu"), 48, k=k,
                    cache=Carried(tspec), device="cpu")
    keys = np.asarray(jax.random.split(key, 48))
    want_p = np.where(np.asarray(want.mask), np.asarray(want.indices), -1)
    got_p = np.where(got.mask.numpy(), got.indices.numpy(), -1)
    assert assert_dual_rows_match(want_p, got_p, keys, jspec, tspec, k,
                                  kdpp=True) == 48
    assert (got.sizes().numpy() == min(k, r)).all()
    assert_rows_valid(got_p, N, k)


def test_sampler_functions_and_hooks_agree():
    """``sample_dual_keyed`` / ``_kdpp_keyed``, the hooks and the keyed
    batched entry points give the same rows for the same keys; ``counts``
    and ``truncated`` follow the Kron contract."""
    _, jspec, _, tspec = pair(64, 6, 4, 3.0)
    keys = tr.split(tr.PRNGKey(5, "cpu"), 16)
    k_max = tspec.suggested_k_max()
    a = sample_dual_keyed(keys, tspec, k_max)
    b = sample_krondpp_keyed(keys, tspec, k_max)
    c = tspec.sample_rows(keys, k_max)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    picks, counts, truncated = a
    assert counts.dtype == torch.int32 and truncated.dtype == torch.bool
    assert ((picks >= 0).sum(1) <= counts).all()
    kd = sample_dual_kdpp_keyed(keys, tspec, 4)
    assert torch.equal(kd, tspec.sample_rows_kdpp(keys, 4))
    assert torch.equal(kd, sample_kdpp_batched(tr.PRNGKey(5, "cpu"), tspec,
                                               4, 16))
    # a forced-tiny budget: truncation is reported, rows stay valid
    big = dpp.LowRank(*inputs(30, 8, 0, qscale=50.0), device="cpu")
    p, cnt, tru = sample_krondpp_batched(tr.PRNGKey(1, "cpu"),
                                         big.spectrum(SpectralCache()), 2,
                                         32)
    assert bool(tru.any()) and (cnt <= 2).all()
    assert_rows_valid(p, 30, 2)


def test_generator_draws_are_valid_and_exact_k():
    tm = dpp.LowRank(*inputs(40, 5, 1), device="cpu").rescale(
        3.0, SpectralCache())
    gen = torch.Generator().manual_seed(0)
    b1 = tm.sample(gen, 64, cache=SpectralCache(), device="cpu")
    assert b1.n == 64 and int(b1.sizes().max()) <= 5
    kd = tm.sample(gen, 64, k=4, cache=SpectralCache(), device="cpu")
    assert (kd.sizes().numpy() == 4).all()
    again = tm.sample(torch.Generator().manual_seed(0), 64,
                      cache=SpectralCache(), device="cpu")
    assert torch.equal(again.indices, b1.indices)


def test_inclusion_frequencies_match_marginal_kernel():
    """3000 generator draws at N = 12, r = 4: singleton frequencies within
    0.05 of diag K (about 5 standard errors), for the DPP and the dense
    oracle's K."""
    tm = dpp.LowRank(*inputs(12, 4, 5), device="cpu").rescale(
        2.5, SpectralCache())
    batch = tm.sample(torch.Generator().manual_seed(1), 3000,
                      cache=SpectralCache(), device="cpu")
    mem = np.zeros((3000, 12))
    for b, row in enumerate(batch.to_lists()):
        mem[b, row] = 1.0
    K = marginal_kernel(np_(tm.dense_kernel()).astype(np.float64))
    diag = np_(torch.diagonal(tm.marginal_kernel_submatrix(range(12))))
    np.testing.assert_allclose(diag, np.diag(K), atol=1e-5)
    assert np.abs(mem.mean(0) - np.diag(K)).max() <= 0.05


def test_samples_never_exceed_rank():
    tm = dpp.LowRank(*inputs(12, 3, 0, qscale=30.0), device="cpu")
    batch = tm.sample(tr.PRNGKey(0, "cpu"), 500, cache=SpectralCache(),
                      device="cpu")
    sizes = batch.sizes().numpy()
    assert sizes.max() <= 3 and sizes.mean() > 1.5


@pytest.mark.parametrize("backend", ["pallas", "cuda", "fused"])
def test_dual_sampler_rejects_fused_backends(backend):
    _, jspec, _, tspec = pair(16, 3, 0, None)
    keys = tr.split(tr.PRNGKey(0, "cpu"), 2)
    jkeys = jax.random.split(jax.random.PRNGKey(0), 2)
    for spec, ks in ((tspec, keys), (jspec, jkeys)):
        with pytest.raises(ValueError, match="no fused"):
            spec.sample_rows(ks, 3, backend=backend)
        with pytest.raises(ValueError, match="no fused"):
            spec.sample_rows_kdpp(ks, 2, backend=backend)
    with pytest.raises(ValueError, match="no fused"):
        tspec.sample_rows(torch.Generator(), 3, backend=backend,
                          num_samples=2)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def test_service_rows_match_jax_service():
    """``service(seed=0)``: ``sample(5)`` (one flush at B = 8),
    ``sample_kdpp(3, 4)`` and ``draw_keyed`` of 12 keys in two chunkings,
    row for row against the JAX service on the carried spectrum."""
    jm, jspec, tm, tspec = pair(64, 6, 6, 3.0)
    jsvc = jm.service(seed=0)
    tsvc = tm.service(seed=0, cache=Carried(tspec), device="cpu")
    k_max = jspec.suggested_k_max()
    assert tsvc.k_max == jsvc.k_max == k_max
    want, got = jsvc.sample(5), tsvc.sample(5)
    key = jax.random.PRNGKey(0)
    key, sub = jax.random.split(key)
    keys = np.asarray(jax.random.split(sub, 8))[:5]
    pad = lambda rows, k: np.array([r + [-1] * (k - len(r)) for r in rows])
    assert_dual_rows_match(pad(want, k_max), pad(got, k_max), keys, jspec,
                           tspec, k_max)
    want_k, got_k = jsvc.sample_kdpp(3, 4), tsvc.sample_kdpp(3, 4)
    key, sub = jax.random.split(key)
    keys = np.asarray(jax.random.split(sub, 4))
    assert_dual_rows_match(pad(want_k, 3), pad(got_k, 3), keys, jspec, tspec,
                           3, kdpp=True)
    row_keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), 12))
    jrows, _, _ = jsvc.draw_keyed(row_keys)
    trows, trunc, collapsed = tsvc.draw_keyed(row_keys)
    chunked = tm.service(seed=0, cache=Carried(tspec), device="cpu",
                         max_batch=4)
    assert chunked.draw_keyed(row_keys)[0] == trows
    assert_dual_rows_match(pad(jrows, k_max), pad(trows, k_max), row_keys,
                           jspec, tspec, k_max)
    assert trunc == 0 and collapsed == 0
    assert tsvc.stats == jsvc.stats()
    assert tsvc.stats() == {"device_calls": 3, "samples_drawn": 24,
                            "samples_requested": 5, "flushes": 1,
                            "truncations": 0}


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def test_log_prob_matches_jax_including_beyond_rank():
    jm, _, tm, _ = pair(64, 6, 7, 3.0)
    key = jax.random.PRNGKey(8)
    jb = jm.sample(key, 40)
    over = [[0, 1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 5, 6, 7, 8]]   # > rank 6
    lists = [r for r in jb.to_lists()] + over + [[]]
    from repro.core import SubsetBatch as JaxSubsetBatch
    jbatch = JaxSubsetBatch.from_lists(lists, k_max=8)
    tbatch = subset_batch_from_numpy(np.asarray(jbatch.indices),
                                     np.asarray(jbatch.mask), "cpu")
    want = np_(jm.log_prob(jbatch)).astype(np.float64)
    got = np_(tm.log_prob(tbatch)).astype(np.float64)
    # beyond the rank det(φ_Y φ_Yᵀ) = 0: -inf, or float32 noise around a
    # zero determinant, in both packages (tests/test_lowrank.py's rule)
    for v in (want[-3:-1], got[-3:-1]):
        assert (np.isneginf(v) | (v < -8.0)).all(), v
    sup = slice(0, len(lists) - 3)
    want_s = np.concatenate([want[sup], want[-1:]])
    got_s = np.concatenate([got[sup], got[-1:]])
    assert np.isfinite(want_s).all() and np.isfinite(got_s).all()
    assert (np.abs(got_s - want_s)
            <= LOGP_RTOL * np.maximum(1.0, np.abs(want_s))).all()
    np.testing.assert_allclose(float(tm.log_likelihood(
        SubsetBatch(tbatch.indices[:40], tbatch.mask[:40]))),
        float(jm.log_likelihood(JaxSubsetBatch(jbatch.indices[:40],
                                               jbatch.mask[:40]))),
        rtol=LOGP_RTOL)


def test_log_prob_matches_enumeration():
    """At N = 8, r = 3 the dual log P against brute-force enumeration of
    the dense kernel; total probability 1."""
    tm = dpp.LowRank(*inputs(8, 3, 0), device="cpu")
    probs = enumerate_probabilities(np_(tm.dense_kernel()).astype(
        np.float64))
    assert sum(probs.values()) == pytest.approx(1.0, abs=1e-4)
    subsets = [[0], [2, 5], [1, 4, 7]]
    lp = np_(tm.log_prob(SubsetBatch.from_lists(subsets, device="cpu")))
    ref = [np.log(probs[tuple(sorted(s))]) for s in subsets]
    np.testing.assert_allclose(lp, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("idx", [3, [0, 3, 7], [5, 5, 1], list(range(10))])
def test_marginals_match_jax(idx):
    jm, _, tm, tspec = pair(64, 6, 9, 3.0)
    cache = Carried(tspec)
    want = np_(jm.marginal_kernel_submatrix(idx))
    got = np_(tm.marginal_kernel_submatrix(idx, cache))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(float(tm.marginal(idx, cache)),
                               float(jm.marginal(idx)), rtol=1e-3,
                               atol=1e-6)
    with pytest.raises(ValueError, match="out of range"):
        tm.marginal_kernel_submatrix([64])


@pytest.mark.parametrize("A", [[2], [1, 5], [0, 10, 20, 30]])
def test_condition_matches_jax(A):
    """The conditioned model is a ``LowRank`` whose V equals the JAX one
    within 1e-4·max|φ|, and the inclusion identity holds."""
    jm, _, tm, _ = pair(64, 6, 10, 3.0)
    jc, tc = jm.condition(A), tm.condition(A)
    assert type(tc) is dpp.LowRank and tc.N == 64 - len(A)
    scale = float(np.abs(np_(tm._phi())).max())
    np.testing.assert_allclose(np_(tc.V), np_(jc.V), atol=1e-4 * scale)
    assert tm.condition([]) is tm
    # log P(A ∪ B ⊆ Y) - log P(A ⊆ Y) = log P(B ⊆ Y | A), B in the
    # complement's numbering
    comp = [i for i in range(64) if i not in A]
    B = [comp[3], comp[7]]
    lhs = np.log(float(tm.marginal(A + B, SpectralCache()))) - \
        np.log(float(tm.marginal(A, SpectralCache())))
    rhs = np.log(float(tc.marginal([3, 7], SpectralCache())))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-3, atol=1e-4)


def test_condition_on_dependent_items_raises_in_both_packages():
    V = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    V[1] = V[0]                            # duplicate item: P({0, 1}) = 0
    for model in (jdpp.LowRank(jnp.asarray(V)),
                  dpp.LowRank(V, device="cpu")):
        with pytest.raises(ValueError, match="singular"):
            model.condition([0, 1])
        assert model.condition([2]).N == 5
    with pytest.raises(ValueError, match="singular"):   # beyond the rank
        dpp.LowRank(V, device="cpu").condition([2, 3, 4, 5])


@pytest.mark.parametrize("N,r,seed,k", [(64, 6, 11, 6), (256, 16, 12, 12),
                                        (40, 8, 13, 1)])
def test_map_matches_jax(N, r, seed, k):
    """Greedy MAP in float64: the same picks in order (k <= rank; past the
    rank the gains are float64 noise)."""
    jm, _, tm, _ = pair(N, r, seed, None)
    got = tm.map(k)
    assert got.dtype == torch.int32 and got.shape == (k,)
    np.testing.assert_array_equal(np_(got), np_(jm.map(k)))
    assert len(set(np_(tm.map(r + 3)).tolist())) == r + 3


# ---------------------------------------------------------------------------
# learning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train():
    """The JAX package's data (a rescaled truth's keyed draws) and init."""
    V, q = inputs(30, 5, 11)
    truth = jdpp.LowRank(jnp.asarray(V), jnp.asarray(q)).rescale(
        3.0, JaxCache())
    data = truth.sample(jax.random.PRNGKey(4), 64)
    V0 = (np.random.default_rng(5).normal(size=(30, 5)) * 0.5).astype(
        np.float32)
    X = np.random.default_rng(6).normal(size=(30, 4)).astype(np.float32)
    return data, V0, X


FIT_CASES = {
    "constant": dict(schedule="constant"),
    "armijo": dict(),
    "minibatch": dict(minibatch_size=24, key=13),
    "features": dict(item_features=True),
    "features_minibatch_constant": dict(item_features=True,
                                        minibatch_size=32, key=3,
                                        schedule="constant"),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_lowrank_matches_jax(train, case):
    """3 sweeps of ``fit_lowrank`` in both packages from the same init:
    LLs within rtol 1e-4, V and q within 1e-3 of their max."""
    data, V0, X = train
    kw = dict(FIT_CASES[case])
    jkw, tkw = {}, {}
    if kw.pop("schedule", None) == "constant":
        jkw["schedule"] = jax_schedules.constant(0.5)
        tkw["schedule"] = schedules.constant(0.5)
    if "key" in kw:
        seed = kw.pop("key")
        jkw["key"] = jax.random.PRNGKey(seed)
        tkw["key"] = key_from_numpy(np.asarray(jkw["key"]), "cpu")
    if kw.pop("item_features", False):
        jkw["item_features"] = tkw["item_features"] = X
    jkw.update(kw)
    tkw.update(kw)
    jrep = jax_fit_lowrank(jdpp.LowRank(jnp.asarray(V0)), data, iters=3,
                           **jkw)
    tbatch = subset_batch_from_numpy(np.asarray(data.indices),
                                     np.asarray(data.mask), "cpu")
    trep = fit_lowrank(dpp.LowRank(V0, device="cpu"), tbatch, iters=3,
                       device="cpu", **tkw)
    assert type(trep.model) is dpp.LowRank
    assert trep.ll_sweeps == jrep.ll_sweeps == [0, 1, 2, 3]
    np.testing.assert_allclose(trep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    for got, want in ((trep.model.V, jrep.model.V),
                      (trep.model.q, jrep.model.q)):
        want = np_(want)
        np.testing.assert_allclose(np_(got), want,
                                   atol=PARAM_REL * np.abs(want).max())
    assert int(trep.state.sched.backtracks) == \
        int(jrep.state.sched.backtracks)
    np.testing.assert_array_equal(tr.key_data(trep.state.key),
                                  np.asarray(jrep.state.key))
    if "minibatch_size" not in kw and "item_features" not in tkw:
        lls = trep.log_likelihoods        # Armijo / small constant: ascent
        assert all(b >= a - 1e-4 for a, b in zip(lls, lls[1:])), lls


def test_fit_through_the_facade_and_api(train):
    """``LowRank.fit`` and ``learning.fit(algorithm="lowrank")`` give the
    same report; other algorithms are refused; ``checkpoint_dir`` is not
    passed on (as in the JAX package: nothing is written)."""
    data, V0, _ = train
    tbatch = subset_batch_from_numpy(np.asarray(data.indices),
                                     np.asarray(data.mask), "cpu")
    model = dpp.LowRank(V0, device="cpu")
    a = model.fit(tbatch, iters=2, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck")
        b = fit((model.V, model.q), tbatch, algorithm="lowrank", iters=2,
                checkpoint_dir=ck, save_every=1, device="cpu")
        jck = os.path.join(d, "jck")
        jax_fit_lowrank_api(V0, data, jck)
        assert not os.path.exists(ck) and not os.path.exists(jck)
    assert a.log_likelihoods == b.log_likelihoods
    assert torch.equal(a.model.V, b.model.V)
    with pytest.raises(ValueError, match="lowrank"):
        model.fit(tbatch, algorithm="em", device="cpu")
    with pytest.raises(ValueError, match="generator"):
        fit(model, tbatch, algorithm="lowrank", device="cpu",
            generator=torch.Generator())
    with pytest.raises(ValueError, match="Local runtime"):
        fit(model, tbatch, algorithm="lowrank", device="cpu",
            runtime=dpp.Mesh(axes={"data": 1}, devices=["cpu"]))
    with pytest.raises(ValueError, match="minibatches of 99"):
        fit(model, tbatch, algorithm="lowrank", device="cpu",
            minibatch_size=99)


def jax_fit_lowrank_api(V0, data, ck):
    from repro.learning import fit as jax_fit
    return jax_fit(jdpp.LowRank(jnp.asarray(V0)), data, algorithm="lowrank",
                   iters=2, checkpoint_dir=ck, save_every=1)


def test_kron_fit_with_lowrank_refused_by_both_packages(train):
    """A Kron model has no (V, q): the port says so with a ValueError, the
    JAX package fails by accident (it passes (L1, L2) on as (V, q) and
    indexes past q)."""
    data, _, _ = train
    jk = jdpp.Kron(jax_random_krondpp(jax.random.PRNGKey(1), (5, 6)))
    with pytest.raises(IndexError):
        jk.fit(data, algorithm="lowrank", iters=1)
    tk = kron_from_numpy([np_(f) for f in jk.factors], device="cpu")
    tbatch = subset_batch_from_numpy(np.asarray(data.indices),
                                     np.asarray(data.mask), "cpu")
    with pytest.raises(ValueError, match="LowRank"):
        tk.fit(tbatch, algorithm="lowrank", device="cpu")
    with pytest.raises(ValueError, match="LowRank"):
        dpp.Dense(tk.dense_kernel(), device="cpu").fit(
            tbatch, algorithm="lowrank", device="cpu")
    with pytest.raises(ValueError, match="Dense/Kron"):
        fit(tk.factors, tbatch, algorithm="lowrank", device="cpu")


def test_fit_emits_learning_telemetry(train):
    """The same ``learning.*`` metric names, spans and health verdict as
    the JAX learner."""
    data, V0, _ = train
    tbatch = subset_batch_from_numpy(np.asarray(data.indices),
                                     np.asarray(data.mask), "cpu")
    with obs.use(obs.InMemoryTracker(keep_records=True)) as t:
        rep = dpp.LowRank(V0, device="cpu").fit(tbatch, iters=3,
                                                log_every=2, device="cpu")
    with jax_obs.use(jax_obs.InMemoryTracker(keep_records=True)) as jt:
        jrep = jdpp.LowRank(jnp.asarray(V0)).fit(data, iters=3, log_every=2)
    assert rep.health is not None
    assert rep.health["verdict"] == jrep.health["verdict"]
    # the port's kernel dispatch counters (kernels.*: its PRNG twin) have
    # no JAX counterpart
    names = lambda trk: sorted({(r["kind"], r["name"]) for r in trk.records
                                if not r["name"].startswith("kernels.")})
    assert names(t) == names(jt)
    spans = lambda trk: sorted(r["tags"]["op"] for r in trk.records
                               if r["name"] == "span")
    assert spans(t) == spans(jt)
    assert t.counter_value("learning.sweeps") == 3
    assert len(t.observations["learning.chunk_s"]) == 2


# ---------------------------------------------------------------------------
# the zero-N×N-eigh guarantee and the cache
# ---------------------------------------------------------------------------

def test_hot_path_never_runs_an_nxn_eigh():
    """N = 600 >> r = 8: spectrum, sampling, log_prob, marginals, rescale
    and a q-only swap cost exactly two r×r eighs (one per (V, q) pair),
    pinned by the ``eigh_s`` timer tags, as ``tests/test_lowrank.py``."""
    N, r = 600, 8
    tracker = obs.InMemoryTracker(keep_records=True)
    cache = SpectralCache()
    with obs.use(tracker):
        m = dpp.LowRank(*inputs(N, r, 3), device="cpu")
        batch = m.sample(tr.PRNGKey(0, "cpu"), 32, cache=cache, device="cpu")
        m.log_prob(batch, cache=cache)
        m.marginal([0, 5], cache=cache)
        m.rescale(4.0, cache=cache)
        m2 = dpp.LowRank(m.V, m.q * 2.0, device="cpu")   # shared V
        m2.sample(tr.PRNGKey(1, "cpu"), 32, k=3, cache=cache, device="cpu")
        m2.expected_size(cache=cache)
        SamplingService(m2, cache=cache, device="cpu").sample(4)
    stats = cache.stats()
    assert stats["misses"] == 2 and stats["evictions"] == 0
    assert stats["hits"] >= 5
    eighs = [rec for rec in tracker.records
             if rec["name"] == "spectral_cache.eigh_s"]
    assert len(eighs) == 2
    assert all(rec["tags"]["n"] == r for rec in eighs), eighs
    assert tracker.counter_value("spectral_cache.misses") == 2


def test_cache_keys_on_identity_and_pins_both_tensors():
    cache = SpectralCache(maxsize=2)
    V, q = inputs(20, 4, 0)
    m = dpp.LowRank(V, q, device="cpu")
    s1 = m.spectrum(cache)
    assert m.spectrum(cache).phi is s1.phi            # a hit
    same_values = dpp.LowRank(V, q, device="cpu")    # new tensors: a miss
    same_values.spectrum(cache)
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 1
    dpp.LowRank(m.V, m.q * 1.0, device="cpu").spectrum(cache)
    assert cache.stats()["evictions"] == 1 and len(cache) == 2


# ---------------------------------------------------------------------------
# construction, features, carrying across
# ---------------------------------------------------------------------------

def test_constructor_validation_matches_jax():
    for make in (lambda V, q=None: jdpp.LowRank(jnp.asarray(V), q),
                 lambda V, q=None: dpp.LowRank(V, q, device="cpu")):
        with pytest.raises(ValueError, match="must be"):
            make(np.ones((4,), np.float32))              # V not 2-D
        with pytest.raises(ValueError, match="q must be"):
            make(np.ones((4, 2), np.float32), np.ones((3,), np.float32))
        m = make(np.ones((4, 2), np.float32))           # q defaults to 1
        np.testing.assert_allclose(np_(m.q), 1.0)
        with pytest.raises(TypeError, match="factor"):
            m.factors
        assert (m.m, m.sizes, m.N, m.rank) == (1, (4,), 4, 2)
        assert repr(m) == "LowRank(N=4, rank=2)"
    m = dpp.LowRank(np.ones((4, 2), np.float64), device="cpu")
    assert m.V.dtype == torch.float32 and m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="max_dense"):
        dpp.LowRank(*inputs(6, 2, 0), device="cpu").dense_kernel(
            max_dense=4)
    with pytest.raises(TypeError, match="factor"):
        m._wrap_factors(())


def test_dense_kernel_matches_jax():
    jm, _, tm, _ = pair(30, 4, 14, None)
    np.testing.assert_allclose(np_(tm.dense_kernel()), np_(jm.dense_kernel()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["nystrom_features", "random_fourier_features"])
@pytest.mark.parametrize("seed,rank,gamma", [(0, 5, None), (1, 12, 0.3),
                                             (2, 40, None)])
def test_feature_maps_match_jax(fn, seed, rank, gamma):
    X = np.random.default_rng(100 + seed).normal(size=(40, 3))
    want = getattr(jax_features, fn)(X, rank, gamma=gamma, seed=seed)
    got = getattr(features, fn)(X, rank, gamma=gamma, seed=seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert getattr(dpp, fn) is getattr(features, fn)


def test_nystrom_full_rank_gives_a_lowrank_kernel_near_the_rbf():
    X = np.random.default_rng(0).normal(size=(10, 2))
    Vt = dpp.nystrom_features(X, 10, gamma=0.5)
    K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1))
    L = np_(dpp.LowRank(Vt, device="cpu").dense_kernel())
    np.testing.assert_allclose(L, K, atol=1e-3)


def test_convert_round_trip():
    _, jspec, _, tspec = pair(20, 4, 15, None)
    for a, b in zip(dual_spectrum_to_numpy(tspec),
                    dual_spectrum_to_numpy(jspec)):
        np.testing.assert_array_equal(a, b)
    m = lowrank_from_numpy(*inputs(5, 2, 0), device="cpu")
    assert type(m) is dpp.LowRank and m.V.dtype == torch.float32
    assert lowrank_from_numpy(np.ones((3, 2)), device="cpu").q.shape == (3,)


def test_jax_reference_runs_on_the_cpu():
    """The reference side of this file computes on the CPU device, even on
    a machine whose jax could see a card."""
    jm, jspec, _, _ = pair(16, 3, 0, None)
    out = jm.log_prob(jm.sample(jax.random.PRNGKey(0), 4))
    assert out.devices() == {jax.devices("cpu")[0]}
    assert jspec.phi.devices() == {jax.devices("cpu")[0]}
    assert jax.default_backend() == "cpu"


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_keyed_draws_on_card_match_the_cpu():
    """On a card: the keyed DPP and k-DPP draws (uniforms from the
    ``threefry2x32`` kernel) against a CPU copy on the same spectrum and
    keys, under the module's rule; log_prob and map against the CPU copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; threefry2x32 has no CPU mode")
    from repro_torch.kernels import threefry
    jm, jspec, tm, tspec = pair(256, 16, 1, 6.0)
    key = tr.PRNGKey(3, "cuda")
    card_spec = tspec.to("cuda")
    threefry.threefry2x32_cuda.launches = 0
    got = sample_krondpp_batched(key, card_spec, None, 64)[0]
    got_k = sample_kdpp_batched(key, card_spec, 5, 64)
    assert threefry.threefry2x32_cuda.launches == 4
    want = sample_krondpp_batched(key.cpu(), tspec, None, 64)[0]
    want_k = sample_kdpp_batched(key.cpu(), tspec, 5, 64)
    keys = tr.key_data(tr.split(key.cpu(), 64))
    assert_dual_rows_match(want.numpy(), got.cpu().numpy(), keys, jspec,
                           tspec, tspec.suggested_k_max())
    assert_dual_rows_match(want_k.numpy(), got_k.cpu().numpy(), keys, jspec,
                           tspec, 5, kdpp=True)
    card = dpp.LowRank(tm.V.cuda(), tm.q.cuda(), device="cuda")
    batch = card.sample(key, 32, cache=SpectralCache())
    lp_c = np_(card.log_prob(batch)).astype(np.float64)
    lp = np_(tm.log_prob(batch)).astype(np.float64)
    assert (np.abs(lp_c - lp) <= LOGP_RTOL * np.maximum(1, np.abs(lp))).all()
    np.testing.assert_array_equal(np_(card.map(12)), np_(tm.map(12)))
