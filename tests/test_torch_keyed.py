"""Keyed draws of the PyTorch port against the JAX package: the same key
gives the same rows.

Both packages draw from the same spectrum (the JAX eigendecomposition,
carried across with ``repro_torch.convert``; the port's facade models and
services read it through a cache that returns it). The port draws its
uniforms from the key with its PRNG twin (``repro_torch.random``), the JAX
package with ``jax.random``. Tolerances:

* uniforms and keys: bit for bit;
* phase-1 masks (u < sigmoid(log λ)): equal, except at a uniform within
  1e-6 of its threshold (the two packages fold log λ in float32 in other
  orders); such a row is a different draw and its picks are not compared;
* picks: equal, or a proven float32 roundoff tie on the exact chain
  (``test_torch_phase2.assert_same_picks``);
* the k-DPP's ESP draw: masks equal;
* learning: minibatch indices equal, the LL trajectory and factors within
  ``tests/test_torch_learning.py``'s float32 tolerances, the final key
  equal.

Sizes: factors of 4 x 5 and 20 x 25, rescaled to a small E|Y|."""

import collections
import os

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
from repro.core import random_krondpp as jax_random_krondpp
from repro.learning import fit as jax_fit
from repro.sampling import SamplingService as JaxService
from repro.sampling import SpectralCache as JaxCache
from repro.sampling.batched import sample_krondpp_batched as jax_sample
from repro.sampling.batched import sample_krondpp_keyed as jax_keyed
from repro.sampling.kdpp import _phase1_kdpp as jax_phase1_kdpp
from repro.sampling.kdpp import sample_kdpp_batched as jax_kdpp
from repro.sampling.kdpp import sample_kdpp_dense as jax_kdpp_dense
from repro.sampling.spectral import log_product_spectrum as jax_lps
from repro.serving.keys import TenantKeyring as JaxKeyring
from repro_torch import dpp
from repro_torch import random as tr
from repro_torch.convert import (factors_to_numpy, key_from_numpy,
                                  kron_from_numpy, spectrum_from_numpy)
from repro_torch.core import random_krondpp
from repro_torch.kernels.phase2_select import canonical_pair
from repro_torch.learning import fit, select_minibatch
from repro_torch.sampling import SamplingService
from repro_torch.sampling.batched import (_phase1_from_uniforms,
                                          compact_selection,
                                          gather_factor_columns,
                                          keyed_uniforms,
                                          sample_krondpp_batched,
                                          sample_krondpp_keyed)
from repro_torch.sampling.kdpp import (_phase1_kdpp_from_uniforms,
                                       sample_kdpp_batched, sample_kdpp_dense)
from repro_torch.sampling.spectral import log_product_spectrum
from repro_torch.serving import TenantKeyring
from test_torch_learning import (FACTOR_TOL, LL_TOL, data, init,  # noqa
                                 jdata, jinit)
from test_torch_phase2 import assert_rows_distinct, assert_same_picks

TIE = 1e-6          # a uniform this close to its threshold may flip a mask
CASES = [((4, 5), 0, 4.0), ((4, 5), 1, 6.0), ((20, 25), 0, 10.0),
         ((20, 25), 1, 12.0)]
Ticket = collections.namedtuple("Ticket", "tenant seq num_samples")


def jax_model(sizes, seed, target):
    """The JAX facade model, its spectrum, and the port's carried copy."""
    jm = jdpp.Kron(jax_random_krondpp(jax.random.PRNGKey(seed), sizes))
    jm = jm.rescale(target, JaxCache())
    jspec = JaxCache().spectrum(jm)
    tspec = spectrum_from_numpy([np.asarray(x) for x in jspec.lams],
                                [np.asarray(x) for x in jspec.vecs],
                                device="cpu")
    return jm, jspec, tspec


class Carried:
    """A spectral cache that hands out the carried spectrum."""

    def __init__(self, spec):
        self.spec = spec

    def spectrum(self, _):
        return self.spec


def jax_row_uniforms(keys, N, k):
    keys = jnp.asarray(keys, jnp.uint32)
    k1, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
    return (np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (N,)))(k1)),
            np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(k2)))


def padded(rows, k):
    out = np.full((len(rows), k), -1, np.int32)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    return out


def assert_dpp_rows_match(want, got, row_keys, jspec, tspec, k_max, label):
    """``want`` (JAX) and ``got`` (port) picks (B, k_max) of the DPP drawn
    from ``row_keys`` (B, 2): the twin's uniforms are JAX's bit for bit,
    the phase-1 masks agree up to ``TIE``, the picks up to a roundoff
    tie on the exact chain. Returns the number of rows compared."""
    want, got = np.asarray(want), np.asarray(got)
    u, us = keyed_uniforms(tr.as_key(row_keys, "cpu"), tspec.N, k_max)
    ju, jus = jax_row_uniforms(row_keys, tspec.N, k_max)
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  ju.view(np.uint32))
    np.testing.assert_array_equal(us.numpy().view(np.uint32),
                                  jus.view(np.uint32))
    p_t = torch.sigmoid(log_product_spectrum(tspec.lams)).numpy()
    p_j = np.asarray(jax.nn.sigmoid(jax_lps(tuple(jspec.lams))))
    m_t, m_j = u.numpy() < p_t, ju < p_j
    flip = (m_t != m_j)
    assert (np.abs(u.numpy() - p_t)[flip] < TIE).all(), label
    same = ~flip.any(axis=1)
    us_t, Gs, k_eff, _ = _phase1_from_uniforms(u, us, tspec.lams,
                                               tspec.vecs, k_max)
    G1, Gr = canonical_pair(Gs)
    rows = np.nonzero(same)[0]
    assert_same_picks(want[rows], got[rows], us_t[rows], G1[rows], Gr[rows],
                      label)
    return len(rows)


def assert_kdpp_rows_match(want, got, row_keys, jspec, tspec, k, label):
    """The k-DPP from ``row_keys``: uniforms bit for bit, the ESP draw's
    masks equal, picks up to a roundoff tie."""
    want, got = np.asarray(want), np.asarray(got)
    u, us = keyed_uniforms(tr.as_key(row_keys, "cpu"), tspec.N, k)
    ll_j = jax_lps(tuple(jspec.lams))
    keys = jnp.asarray(row_keys, jnp.uint32)
    k1 = jax.vmap(jax.random.split)(keys)[:, 0]
    m_j = np.asarray(jax.vmap(lambda kk: jax_phase1_kdpp(kk, ll_j, k))(k1))
    mask = _phase1_kdpp_from_uniforms(u, log_product_spectrum(tspec.lams), k)
    np.testing.assert_array_equal(mask.numpy(), m_j, err_msg=label)
    sel, valid, _ = compact_selection(mask, k)
    G1, Gr = canonical_pair(gather_factor_columns(tspec.vecs, tspec.sizes,
                                                  sel, valid))
    assert_same_picks(want, got, us, G1, Gr, label)


@pytest.mark.parametrize("sizes,seed,target", CASES, ids=str)
def test_batched_and_keyed_draws_match_jax(sizes, seed, target):
    _, jspec, tspec = jax_model(sizes, seed, target)
    k_max = jspec.suggested_k_max()
    B = 16
    key = jax.random.PRNGKey(100 + seed)
    want, _, trunc = jax_sample(key, jspec, k_max, B)
    got, _, trunc_t = sample_krondpp_batched(
        key_from_numpy(np.asarray(key), "cpu"), tspec, k_max, B)
    assert got.dtype == torch.int32 and got.shape == (B, k_max)
    keys = np.asarray(jax.random.split(key, B))
    n = assert_dpp_rows_match(want, got, keys, jspec, tspec, k_max,
                              f"batched {sizes} {seed}")
    assert n >= B - 1
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc))
    assert_rows_distinct(got)
    # the keyed entry point, rows from their own keys: a numpy uint32 key
    # batch from JAX works as a twin key batch does
    row_keys = np.asarray(jax.random.split(jax.random.PRNGKey(7 + seed), 9))
    want_k, _, _ = jax_keyed(jnp.asarray(row_keys), jspec, k_max)
    got_k, _, _ = sample_krondpp_keyed(row_keys, tspec, k_max)
    assert_dpp_rows_match(want_k, got_k, row_keys, jspec, tspec, k_max,
                          f"keyed {sizes} {seed}")
    again, _, _ = sample_krondpp_keyed(tr.as_key(row_keys), tspec, k_max)
    assert torch.equal(again, got_k)
    # a row's draw does not depend on its neighbours
    sub, _, _ = sample_krondpp_keyed(row_keys[3:5], tspec, k_max)
    assert torch.equal(sub, got_k[3:5])


@pytest.mark.parametrize("sizes,seed,target", CASES[::2], ids=str)
def test_kdpp_draws_match_jax(sizes, seed, target):
    _, jspec, tspec = jax_model(sizes, seed, target)
    k, B = 3, 12
    key = jax.random.PRNGKey(30 + seed)
    want = jax_kdpp(key, jspec, k, B)
    got = sample_kdpp_batched(key_from_numpy(np.asarray(key), "cpu"),
                              tspec, k, B)
    assert got.shape == (B, k)
    assert_kdpp_rows_match(want, got, np.asarray(jax.random.split(key, B)),
                           jspec, tspec, k, f"kdpp {sizes}")
    assert (got >= 0).all()
    assert_rows_distinct(got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_kdpp_dense_matches_jax(seed):
    """One exact k-DPP sample from a dense kernel, from one key. Each
    package takes its own eigh of L (eigenvalues within float32
    roundoff): the draws are equal where no uniform sits on a
    threshold."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((12, 12)).astype(np.float32)
    L = X @ X.T / 12 + 0.1 * np.eye(12, dtype=np.float32)
    key = jax.random.PRNGKey(40 + seed)
    want = np.asarray(jax_kdpp_dense(key, jnp.asarray(L), 4))
    got = sample_kdpp_dense(np.asarray(key), torch.from_numpy(L), 4)
    assert got.dtype == torch.int32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sizes", [(4, 5), (20, 25)], ids=str)
def test_random_kron_matches_jax(sizes):
    """The same key builds the same factors: X bit for bit (the uniforms),
    X^T X + 1e-3 I within float32 roundoff of the product."""
    key = jax.random.PRNGKey(3)
    want = jdpp.random_kron(key, sizes, scale=0.5)
    got = dpp.random_kron(key_from_numpy(np.asarray(key), "cpu"), sizes,
                          device="cpu", scale=0.5)
    for g, w in zip(factors_to_numpy(got), want.factors):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    core = random_krondpp(tr.PRNGKey(3, "cpu"), sizes, device="cpu")
    jcore = jax_random_krondpp(key, sizes)
    for g, w in zip(core.factors, jcore.factors):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("sizes,scale", [((4, 5), 1.0), ((6, 3, 2), 0.5)],
                         ids=str)
def test_random_kron_takes_the_jax_argument_order(sizes, scale):
    """``random_kron(key, sizes, dtype, scale)`` and ``random_krondpp`` take
    the JAX package's positional order, ``device`` by keyword only: the
    same factors as the JAX call for the same key, float64 on request."""
    import inspect
    key = jax.random.PRNGKey(7)
    tkey = key_from_numpy(np.asarray(key), "cpu")
    want = jdpp.random_kron(key, sizes, jnp.float32, scale)
    got = dpp.random_kron(tkey, sizes, torch.float32, scale, device="cpu")
    core = random_krondpp(tkey, sizes, torch.float32, scale, device="cpu")
    for g, c, w in zip(got.factors, core.factors, want.factors):
        assert g.dtype == c.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
        assert torch.equal(g, c)
    wide = random_krondpp(tkey, sizes, torch.float64, scale, device="cpu")
    for f, c in zip(wide.factors, core.factors):
        assert f.dtype == torch.float64
        np.testing.assert_allclose(f.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))
    for fn, jfn in ((dpp.random_kron, jdpp.random_kron),
                    (random_krondpp, jax_random_krondpp)):
        params = inspect.signature(fn).parameters
        assert list(params)[:4] == list(inspect.signature(jfn).parameters)
        assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    with pytest.raises(TypeError):
        dpp.random_kron(tkey, sizes, torch.float32, scale, "cpu")


def test_facade_reexports_schedules():
    """``dpp.schedules`` is the learning schedules module in both packages
    (``examples/quickstart.py`` spells ``dpp.schedules.armijo()``)."""
    from repro_torch.learning import schedules
    assert dpp.schedules is schedules
    assert "schedules" in dpp.__all__ and "schedules" in jdpp.__all__
    for name in ("constant", "inv_sqrt", "armijo"):
        assert dataclasses_fields(getattr(dpp.schedules, name)()) == \
            dataclasses_fields(getattr(jdpp.schedules, name)())
    assert dataclasses_fields(dpp.schedules.by_name("inv-sqrt", 0.5)) == \
        dataclasses_fields(jdpp.schedules.by_name("inv-sqrt", 0.5))


def dataclasses_fields(sched):
    import dataclasses
    return {f.name: getattr(sched, f.name)
            for f in dataclasses.fields(sched)}


def test_model_sample_with_a_key_matches_jax():
    """``model.sample(key, n)`` and ``(key, n, k=)`` on the facade: the JAX
    facade's rows for the same key; a numpy key, a twin key and a key on
    another device draw alike."""
    jm, jspec, tspec = jax_model((4, 5), 2, 5.0)
    model = kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu")
    cache = Carried(tspec)
    key = jax.random.PRNGKey(9)
    k_max = jspec.suggested_k_max()
    want = jm.sample(key, 8, cache=JaxCache())
    got = model.sample(np.asarray(key), 8, cache=cache, device="cpu")
    keys = np.asarray(jax.random.split(key, 8))
    assert_dpp_rows_match(np.where(want.mask, want.indices, -1),
                          torch.where(got.mask, got.indices, -1).numpy(),
                          keys, jspec, tspec, k_max, "model.sample")
    twin = model.sample(tr.PRNGKey(9, "cpu"), 8, cache=cache, device="cpu")
    assert torch.equal(twin.indices, got.indices)
    assert torch.equal(twin.truncated, got.truncated)
    want_k = jm.sample(key, (2, 3), k=3, cache=JaxCache())
    got_k = model.sample(key_from_numpy(np.asarray(key), "cpu"), (2, 3), k=3,
                         cache=cache, device="cpu")
    assert_kdpp_rows_match(np.asarray(want_k.indices), got_k.indices,
                           np.asarray(jax.random.split(key, 6)), jspec,
                           tspec, 3, "model.sample(k=3)")


def jax_service_keys(seed, batches):
    """The row keys of a JAX service's device calls of ``batches`` rows:
    ``key, sub = split(key)`` per call, ``split(sub, batch)`` per row."""
    key = jax.random.PRNGKey(seed)
    out = []
    for b in batches:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.split(sub, b)))
    return out


def test_seeded_service_matches_jax_over_several_calls():
    """The same seed and the same sequence of calls: the JAX service's
    rows, flush by flush (coalesced, rounded up, chunked at max_batch) and
    for ``sample_kdpp``."""
    jm, jspec, tspec = jax_model((4, 5), 3, 5.0)
    k_max = jspec.suggested_k_max()
    model = kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu")
    jsvc = JaxService(jm, cache=JaxCache(), seed=5, max_batch=8)
    tsvc = SamplingService(model, cache=Carried(tspec), seed=5, max_batch=8,
                           device="cpu")
    assert tsvc.k_max == jsvc.k_max == k_max

    def drive(svc):
        a, b = svc.submit(2), svc.submit(3)     # one flush of 8
        out = [a.result(), b.result(), svc.sample(1),  # a flush of 1
               svc.sample(13),                  # 16 rows in two chunks
               svc.sample_kdpp(3, 5)]           # one k-DPP call of 8
        return out

    jout, tout = drive(jsvc), drive(tsvc)
    calls = jax_service_keys(5, [8, 1, 8, 8, 8])
    flush_rows = [(jout[0] + jout[1], tout[0] + tout[1], calls[0]),
                  (jout[2], tout[2], calls[1]),
                  (jout[3][:8], tout[3][:8], calls[2]),
                  (jout[3][8:], tout[3][8:], calls[3])]
    for i, (jr, tr_rows, keys) in enumerate(flush_rows):
        assert len(jr) == len(tr_rows)
        assert_dpp_rows_match(padded(jr, k_max), padded(tr_rows, k_max),
                              keys[:len(jr)], jspec, tspec, k_max,
                              f"service call {i}")
    assert_kdpp_rows_match(padded(jout[4], 3), padded(tout[4], 3),
                           calls[4][:5], jspec, tspec, 3,
                           "service sample_kdpp")
    assert tsvc.stats() == jsvc.stats()
    np.testing.assert_array_equal(tr.key_data(tsvc._key),
                                  np.asarray(jsvc._key))


def test_draw_keyed_and_tenant_keyring_match_jax():
    """``TenantKeyring.row_keys`` gives the JAX keyring's keys (tenants,
    sequence numbers, pad rows); ``draw_keyed`` on them the JAX service's
    rows, counted as the JAX service counts them."""
    jm, jspec, tspec = jax_model((4, 5), 4, 5.0)
    k_max = jspec.suggested_k_max()
    tickets = [Ticket("alpha", 0, 1), Ticket("beta", 3, 4),
               Ticket("alpha", 1, 6), Ticket("gamma", 7, 2)]
    keys = TenantKeyring(11, device="cpu").row_keys(tickets, 16)
    jkeys = np.asarray(JaxKeyring(11).row_keys(tickets, 16))
    np.testing.assert_array_equal(tr.key_data(keys), jkeys)
    kr = TenantKeyring(11, device="cpu")
    np.testing.assert_array_equal(kr.tenant_key("beta"),
                                  JaxKeyring(11).tenant_key("beta"))
    model = kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu")
    jsvc = JaxService(jm, cache=JaxCache(), seed=0, max_batch=8)
    tsvc = SamplingService(model, cache=Carried(tspec), seed=0, max_batch=8,
                           device="cpu")
    jrows, jtr, jcol = jsvc.draw_keyed(jkeys)
    rows, trunc, col = tsvc.draw_keyed(keys)
    assert (trunc, col) == (jtr, jcol) and len(rows) == 16
    assert_dpp_rows_match(padded(jrows, k_max), padded(rows, k_max), jkeys,
                          jspec, tspec, k_max, "draw_keyed")
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.stats.device_calls == 2


def test_draw_keyed_is_invariant_to_max_batch():
    """Row i is a function of key i alone: chunks of 3, 8 or 64 give the
    same rows, and one key drawn alone its row."""
    jm, _, tspec = jax_model((20, 25), 5, 8.0)
    model = kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu")
    keys = TenantKeyring(2, device="cpu").row_keys(
        [Ticket("a", 0, 5), Ticket("b", 1, 12)], 32)
    out = {}
    for mb in (3, 8, 64):
        svc = SamplingService(model, cache=Carried(tspec), max_batch=mb,
                              device="cpu")
        out[mb] = svc.draw_keyed(keys)[0]
        assert svc.stats.device_calls == -(-32 // mb)
    assert out[3] == out[8] == out[64]
    single = SamplingService(model, cache=Carried(tspec), device="cpu")
    assert single.draw_keyed(keys[17:18])[0] == [out[64][17]]


def test_stochastic_fit_draws_jax_minibatches(jdata, jinit, data, init):
    """``krk-stochastic`` over 5 sweeps from a seed: JAX's key stream
    (``key, k_sel = split(key)`` a sweep), so the same minibatch indices
    every sweep, the same LL trajectory and factors, the same final key."""
    kw = dict(algorithm="krk-stochastic", iters=5, minibatch_size=8, a=0.7,
              seed=4)
    rep = fit(init, data, device="cpu", **kw)
    jrep = jax_fit(jinit, jdata, **kw)
    key, jkey = tr.PRNGKey(4, "cpu"), jax.random.PRNGKey(4)
    for _ in range(5):
        key, k_sel = tr.split(key)
        jkey, jk_sel = jax.random.split(jkey)
        got = tr.choice(k_sel, data.n, (8,), replace=False)
        want = jax.random.choice(jk_sel, jdata.indices.shape[0], (8,),
                                 replace=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        sub = select_minibatch(k_sel, data, 8)
        np.testing.assert_array_equal(sub.indices.numpy(),
                                      np.asarray(jdata.indices)[got.numpy()])
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    for g, w in zip(rep.model.factors, jrep.model.factors):
        np.testing.assert_allclose(g, np.asarray(w), **FACTOR_TOL)
    np.testing.assert_array_equal(tr.key_data(rep.state.key),
                                  np.asarray(jrep.state.key))
    # an explicit key (a JAX key's words) is the same stream as its seed
    jkey4 = np.asarray(jax.random.PRNGKey(4))
    keyed = fit(init, data, device="cpu", key=jkey4,
                **{k: v for k, v in kw.items() if k != "seed"})
    for g, w in zip(keyed.model.factors, rep.model.factors):
        assert torch.equal(g, w)


def test_batch_fit_splits_its_key_every_sweep(jdata, jinit, data, init):
    """A full-batch fit draws no minibatch but splits its key each sweep,
    as the JAX engine does, so the key stream stays aligned."""
    rep = fit(init, data, iters=3, seed=6, device="cpu")
    jrep = jax_fit(jinit, jdata, iters=3, seed=6)
    np.testing.assert_array_equal(tr.key_data(rep.state.key),
                                  np.asarray(jrep.state.key))


@pytest.mark.cuda
def test_keyed_draws_on_card_match_plain_and_jax():
    """On a card: the keyed draw through the kernels (threefry2x32 and
    phase 2) against the same keys through the plain twin on the card (the
    uniforms bit for bit) and the plain phase 2 (picks up to a roundoff
    tie), and against the JAX package's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.kernels import threefry
    # the JAX reference stays on the CPU even where jax sees the card (its
    # float32 products there may run in TF32)
    with jax.default_device(jax.devices("cpu")[0]):
        _, jspec, tspec = jax_model((20, 25), 0, 10.0)
        k_max = jspec.suggested_k_max()
        key = jax.random.PRNGKey(21)
        want, _, _ = jax_sample(key, jspec, k_max, 64)
        keys = np.asarray(jax.random.split(key, 64))
    spec = tspec.to("cuda")
    threefry.threefry2x32_cuda.launches = 0
    got, _, _ = sample_krondpp_batched(key_from_numpy(np.asarray(key)),
                                       spec, k_max, 64)
    assert threefry.threefry2x32_cuda.launches > 0
    row_keys = tr.split(key_from_numpy(np.asarray(key)), 64)
    u, us = keyed_uniforms(row_keys, spec.N, k_max)
    sub = tr.split(tr.split(key_from_numpy(np.asarray(key)), 64,
                            backend="reference"), backend="reference")
    u_p = tr.uniform(sub[:, 0], (spec.N,), backend="reference")
    us_p = tr.uniform(sub[:, 1], (k_max,), backend="reference")
    assert torch.equal(u.view(torch.int32), u_p.view(torch.int32))
    assert torch.equal(us.view(torch.int32), us_p.view(torch.int32))
    with jax.default_device(jax.devices("cpu")[0]):
        assert_dpp_rows_match(want, got.cpu(), keys, jspec, tspec, k_max,
                              "card")
