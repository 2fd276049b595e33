"""Phase 1 and whole draws of the PyTorch port against the JAX package.

Both packages sample from the same spectrum (the JAX eigendecomposition,
carried across with ``repro_torch.convert``) and the same uniforms (drawn
here exactly as JAX's ``_phase1_one`` draws them: per row key,
``k1, k2 = split(key)``, ``u = uniform(k1, (N,))``,
``us = uniform(k2, (k_max,))``). Phase-1 outputs must be equal; picks
equal up to a named CDF-boundary tie (``test_torch_phase2``).
"""

import os

# the JAX reference runs on the CPU, never on the card
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KronDPP, random_krondpp
from repro.core.dpp import marginal_kernel as jax_marginal_kernel
from repro.sampling import SpectralCache
from repro.sampling.batched import _phase1_one
from repro.sampling.batched import compact_selection as jax_compact
from repro.sampling.batched import sample_krondpp_batched as jax_sample
from repro.sampling.spectral import log_product_spectrum as jax_lps
from repro_torch.convert import kron_from_numpy, spectrum_from_numpy
from repro_torch.core.dpp import marginal_kernel
from repro_torch.kernels.phase2_select import canonical_pair
from repro_torch.sampling import batched as tb
from repro_torch.sampling.spectral import log_product_spectrum
from test_torch_phase2 import assert_rows_distinct, assert_same_picks


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def jax_uniforms(key, B, N, k_max):
    keys = jax.random.split(key, B)
    k1, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (N,)))(k1)
    us = jax.vmap(lambda k: jax.random.uniform(k, (k_max,)))(k2)
    return keys, u, us


def carried(spec):
    return spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                               [np.asarray(x) for x in spec.vecs],
                               device="cpu")


@pytest.mark.parametrize("sizes,seed", [((3, 4), 0), ((6, 5), 1),
                                        ((2, 3, 2), 0), ((12,), 1)])
def test_phase1_and_draws_match_jax_on_its_uniforms(sizes, seed):
    m = random_krondpp(jax.random.PRNGKey(seed), sizes)
    spec = SpectralCache().spectrum(m)
    k_max = spec.suggested_k_max()
    B, N = 24, spec.N
    key = jax.random.PRNGKey(200 + seed)
    keys, u, us = jax_uniforms(key, B, N, k_max)
    tspec = carried(spec)
    lams, vecs = tuple(spec.lams), tuple(spec.vecs)

    # the spectrum draw and its compaction
    ll = jax_lps(lams)
    mask = u < jax.nn.sigmoid(ll)[None, :]
    ll_t = log_product_spectrum(tspec.lams)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll), rtol=1e-5)
    mask_t = t(u) < torch.sigmoid(ll_t)[None, :]
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask))
    sel, valid, trunc = jax.vmap(lambda mk: jax_compact(mk, k_max))(mask)
    sel_t, valid_t, trunc_t = tb.compact_selection(mask_t, k_max)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc))

    # phase 1 as a whole
    _, Gs, k_eff, trunc1 = jax.jit(jax.vmap(
        lambda k: _phase1_one(k, lams, vecs, k_max)))(keys)
    _, Gs_t, k_eff_t, trunc1_t = tb._phase1_from_uniforms(
        t(u), t(us), tspec.lams, tspec.vecs, k_max)
    np.testing.assert_array_equal(k_eff_t.numpy(), np.asarray(k_eff))
    np.testing.assert_array_equal(trunc1_t.numpy(), np.asarray(trunc1))
    assert len(Gs_t) == len(Gs)
    for G, G_t in zip(Gs, Gs_t):
        np.testing.assert_allclose(G_t.numpy(), np.asarray(G), atol=1e-6)

    # whole draws: the port on JAX's uniforms vs JAX on the same key
    want, counts, trunc2 = jax_sample(key, spec, k_max, B)
    picks, counts_t, trunc2_t = tb.sample_krondpp_from_uniforms(
        t(u), t(us), tspec, k_max)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(trunc2_t.numpy(), np.asarray(trunc2))
    G1, Gr = canonical_pair(Gs_t)
    assert_same_picks(want, picks.numpy(), t(us), G1, Gr,
                      f"sample sizes={sizes} seed={seed}")
    assert_rows_distinct(picks)


def test_truncation_flag_and_counts():
    """A forced-tiny k_max flags every draw and clips counts to it; an
    adequate budget flags none (as in the JAX package)."""
    big = KronDPP((5.0 * jnp.eye(3), 5.0 * jnp.eye(3)))   # E|Y| ~ 8.7
    tspec = carried(SpectralCache().spectrum(big))
    gen = torch.Generator().manual_seed(0)
    picks, counts, truncated = tb.sample_krondpp_batched(gen, tspec, 2, 8)
    assert picks.shape == (8, 2) and picks.dtype == torch.int32
    assert truncated.all() and (counts == 2).all()
    _, _, truncated = tb.sample_krondpp_batched(gen, tspec, tspec.N, 8)
    assert not truncated.any()


def _membership(picks, N):
    arr = picks.numpy()
    out = np.zeros((arr.shape[0], N))
    for b, row in enumerate(arr):
        out[b, row[row >= 0]] = 1.0
    return out


@pytest.mark.parametrize("sizes", [(2, 3), (2, 2, 2)])
def test_marginals_of_port_draws(sizes):
    """3000 port draws: inclusion frequencies match diag K at atol 0.05
    (about 5 standard errors), as the JAX package's statistical tests."""
    m = random_krondpp(jax.random.PRNGKey(5), sizes)
    model = kron_from_numpy([np.asarray(f) for f in m.factors],
                            device="cpu")
    K = jax_marginal_kernel(np.asarray(m.full_matrix()))
    K_t = marginal_kernel(model.dense_kernel().double().numpy())
    np.testing.assert_allclose(K_t, K, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    batch = model.sample(gen, 3000, device="cpu")
    mem = _membership(torch.where(batch.mask, batch.indices, -1), model.N)
    np.testing.assert_allclose(mem.mean(0), np.diag(K), atol=0.05)
    assert (batch.sizes().numpy() == mem.sum(1)).all()
