"""The PyTorch port's facade inference — ``log_prob``, ``log_likelihood``,
``marginal``, ``marginal_kernel_submatrix`` and ``condition`` — on
``Dense`` and m=2 ``Kron`` models: the brute-force suite of
``tests/test_dpp_facade.py`` (enumeration over the full kernel at N = 6,
with the port's own oracle), and the port held against the JAX facade on
the same factors at float32 tolerance."""

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
from repro.core import SubsetBatch as JaxBatch
from repro_torch import dpp
from repro_torch.convert import subset_batch_from_numpy
from repro_torch.core import SubsetBatch
from repro_torch.core.dpp import enumerate_probabilities, marginal_kernel

N = 6          # ground set size — small enough to enumerate all 2^N subsets


def _jax_model(kind: str):
    kron = jdpp.random_kron(jax.random.PRNGKey(5), (2, 3))
    if kind == "kron":
        return kron
    return jdpp.from_kernel(kron.dense_kernel())


def _port(jmodel):
    """The port's model over the JAX model's factors, on the CPU."""
    factors = [np.asarray(f) for f in jmodel.factors]
    if len(factors) == 1:
        return dpp.from_kernel(factors[0], device="cpu")
    return dpp.Kron(factors, device="cpu")


@pytest.fixture(scope="module", params=["dense", "kron"])
def models(request):
    jmodel = _jax_model(request.param)
    return jmodel, _port(jmodel)


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def oracle(model):
    """Brute-force probabilities + marginal kernel for the same kernel."""
    L = model.dense_kernel().double().numpy()
    return enumerate_probabilities(L), marginal_kernel(L)


def _batch(subsets, k_max=None):
    """The same padded batch for both packages."""
    k_max = k_max or max(1, max(len(s) for s in subsets))
    idx = np.zeros((len(subsets), k_max), np.int32)
    mask = np.zeros((len(subsets), k_max), bool)
    for i, s in enumerate(subsets):
        idx[i, :len(s)] = s
        mask[i, :len(s)] = True
    return (subset_batch_from_numpy(idx, mask, device="cpu"),
            JaxBatch(jnp.asarray(idx), jnp.asarray(mask)))


def _membership(batch: SubsetBatch, n_items: int) -> np.ndarray:
    out = np.zeros((batch.n, n_items))
    for i, row in enumerate(batch.to_lists()):
        out[i, row] = 1.0
    return out


# ---------------------------------------------------------------------------
# the brute-force suite — identical assertions for Dense and Kron
# ---------------------------------------------------------------------------

def test_log_prob_matches_enumerated_reference(model, oracle):
    probs, _ = oracle
    subsets = [[0], [1, 3], [0, 2, 5], [2], [0, 1, 2, 3, 4, 5]]
    batch, _ = _batch(subsets)
    lp = model.log_prob(batch)
    assert lp.shape == (5,) and lp.device.type == "cpu"
    ref = [np.log(probs[tuple(sorted(s))]) for s in subsets]
    np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-4, atol=1e-5)
    # log_likelihood is the batch mean of log_prob
    np.testing.assert_allclose(float(model.log_likelihood(batch)),
                               np.mean(ref), rtol=1e-4, atol=1e-5)
    # the empty set: log P(∅) = -log det(L + I)
    empty = SubsetBatch(torch.zeros((1, 2), dtype=torch.int32),
                        torch.zeros((1, 2), dtype=torch.bool))
    np.testing.assert_allclose(float(model.log_prob(empty)[0]),
                               np.log(probs[()]), rtol=1e-4, atol=1e-5)


def test_marginal_matches_bruteforce(model, oracle):
    probs, K = oracle
    for i in (0, 4):
        bf = sum(p for Y, p in probs.items() if i in Y)
        np.testing.assert_allclose(float(model.marginal(i)), bf,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(model.marginal(i)), K[i, i],
                                   rtol=1e-4, atol=1e-5)
    for S in ([1, 4], [0, 2, 5]):
        bf = sum(p for Y, p in probs.items() if set(S) <= set(Y))
        np.testing.assert_allclose(float(model.marginal(S)), bf,
                                   rtol=1e-3, atol=1e-5)


def test_marginal_input_validation(model, oracle):
    _, K = oracle
    for bad in (N, -1, [0, N]):
        with pytest.raises(ValueError, match="out of range"):
            model.marginal(bad)
    with pytest.raises(ValueError, match="1-D"):
        model.marginal([[0, 1]])
    # duplicate indices have set semantics: P({3,3} ⊆ Y) = P(3 ∈ Y)
    np.testing.assert_allclose(float(model.marginal([3, 3])), K[3, 3],
                               rtol=1e-4, atol=1e-5)


def test_condition_matches_bruteforce(model, oracle):
    probs, _ = oracle
    A = [2]
    cond = model.condition(A)
    assert type(cond) is dpp.Dense and cond.device == model.device
    comp = [i for i in range(N) if i not in A]
    assert cond.N == len(comp)
    Z_A = sum(p for Y, p in probs.items() if set(A) <= set(Y))
    # conditional subset probabilities: P(B ∪ A | A ⊆ Y)
    for B in ([], [1], [1, 4], [0, 3, 5]):
        want = probs[tuple(sorted(set(B) | set(A)))] / Z_A
        batch, _ = _batch([[comp.index(b) for b in B]])
        got = float(torch.exp(cond.log_prob(batch)[0]))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    # conditional marginals: P(i ∈ Y | A ⊆ Y)
    for i in comp:
        bf = sum(p for Y, p in probs.items()
                 if set(A) <= set(Y) and i in Y) / Z_A
        np.testing.assert_allclose(float(cond.marginal(comp.index(i))), bf,
                                   rtol=1e-3, atol=1e-5)


def test_condition_two_items_then_sample(model, oracle):
    """Conditioning composes with sampling: empirical singleton marginals
    of the conditioned model match the brute-force conditional marginals."""
    probs, _ = oracle
    A = [0, 3]
    cond = model.condition(A)
    comp = [i for i in range(N) if i not in A]
    Z_A = sum(p for Y, p in probs.items() if set(A) <= set(Y))
    want = np.array([sum(p for Y, p in probs.items()
                         if set(A) <= set(Y) and i in Y) / Z_A
                     for i in comp])
    S = 3000
    gen = torch.Generator().manual_seed(7)
    mem = _membership(cond.sample(gen, S, device="cpu"), cond.N)
    np.testing.assert_allclose(mem.mean(0), want, atol=0.045)


def test_condition_input_validation(model):
    with pytest.raises(ValueError, match="out of range"):
        model.condition([0, N])
    assert model.condition([]) is model      # empty observed is a no-op


def test_condition_on_zero_probability_set_raises():
    """Conditioning on linearly dependent items of a rank-deficient kernel
    (P(A ⊆ Y) = 0) fails loudly: ``torch.linalg.cholesky`` would raise
    its own error here, and ``jnp.linalg.cholesky`` gives NaN."""
    x = np.asarray([1.0, 1.0, 0.5, -0.2])
    rank1 = dpp.from_kernel(np.outer(x, x), device="cpu")
    with pytest.raises(ValueError, match="singular"):
        rank1.condition([0, 1])


def test_kron_condition_guard_and_empty_set():
    """An 80 x 80 Kron (N = 6400) conditions only past an explicit
    ``max_dense``; an empty ``observed`` needs no dense kernel."""
    big = dpp.random_kron(torch.Generator().manual_seed(0), (80, 80),
                          device="cpu")
    with pytest.raises(ValueError, match="max_dense"):
        big.condition([0])
    assert big.condition([]) is big
    with pytest.raises(ValueError, match="out of range"):
        big.condition([6400])


def test_spectrum_is_cached_across_facade_calls(model):
    cache = dpp.SpectralCache()
    batch, _ = _batch([[0, 1], [2]])
    model.log_prob(batch, cache=cache)
    model.marginal(0, cache=cache)
    model.marginal([0, 4], cache=cache)
    assert cache.stats()["misses"] == model.m     # one eigh per factor ever
    assert cache.stats()["hits"] == 2 * model.m


# ---------------------------------------------------------------------------
# the port against the JAX facade on the same factors
# ---------------------------------------------------------------------------

def test_facade_calls_match_jax_at_n6(models):
    jmodel, model = models
    batch, jbatch = _batch([[0], [1, 3], [0, 2, 5], [], [0, 1, 2, 3, 4, 5]])
    np.testing.assert_allclose(model.log_prob(batch).numpy(),
                               np.asarray(jmodel.log_prob(jbatch)),
                               rtol=1e-4, atol=1e-5)
    for S in (3, [1, 4], [0, 2, 5]):
        np.testing.assert_allclose(float(model.marginal(S)),
                                   float(jmodel.marginal(S)),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.condition([2, 4]).L.numpy(),
                               np.asarray(jmodel.condition([2, 4]).L),
                               atol=1e-5)


def _subsets(rng, n_items: int, n: int, k_max: int):
    """n random subsets of [0, n_items), sizes 0..k_max (the first empty)."""
    sizes = rng.integers(0, k_max + 1, size=n)
    sizes[0] = 0
    return [sorted(rng.choice(n_items, s, replace=False).tolist())
            for s in sizes]


@pytest.mark.parametrize("kind", ["dense", "kron"])
def test_log_prob_matches_jax_on_64_subsets(kind):
    """64 subsets (one empty) of a 10 x 12 model, N = 120."""
    jmodel = jdpp.random_kron(jax.random.PRNGKey(1), (10, 12))
    if kind == "dense":
        jmodel = jdpp.from_kernel(jmodel.dense_kernel())
    model = _port(jmodel)
    subsets = _subsets(np.random.default_rng(0), 120, 64, 8)
    batch, jbatch = _batch(subsets, k_max=8)
    lp = model.log_prob(batch)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jmodel.log_prob(jbatch)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(model.log_likelihood(batch)),
                               float(jmodel.log_likelihood(jbatch)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sizes", [(120,), (10, 12), (2, 2, 3)],
                         ids=["m1", "m2", "m3"])
def test_marginal_kernel_submatrix_matches_jax(sizes):
    """K[idx, idx] off the factored spectrum for m = 1 (a dense 120 x 120
    kernel), m = 2 and m = 3, on a 10-item set (unsorted, one repeat).

    The models are rescaled to E|Y| = 5, as a user's model is: a float32
    eigh's eigenvalues err by about 2^-24·‖L‖, and the unscaled dense
    kernel's ‖L‖ is in the thousands (E|Y| ≈ 64), which puts both
    packages' K off the float64 one by more than this atol; rescaled, ‖L‖
    is about 10."""
    if len(sizes) == 1:
        kern = jdpp.random_kron(jax.random.PRNGKey(2), (10, 12)).dense_kernel()
        jmodel = jdpp.from_kernel(kern).rescale(5.0)
    else:
        jmodel = jdpp.random_kron(jax.random.PRNGKey(2), sizes).rescale(5.0)
    model = _port(jmodel)
    n = model.N
    idx = [n - 1, 0, 5, 7, 3, 10, 9, 2, 8, 6, 5]
    got = model.marginal_kernel_submatrix(idx)
    assert got.shape == (10, 10)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.marginal_kernel_submatrix(idx)),
                               atol=1e-5)
    # against K = L (L + I)^{-1} in float64 (sorted, deduplicated items)
    K = marginal_kernel(model.dense_kernel(max_dense=n).double().numpy())
    s = sorted(set(idx))
    np.testing.assert_allclose(got.numpy(), K[np.ix_(s, s)], atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "kron"])
def test_condition_matches_jax(kind):
    """The Schur complement of a 10 x 12 model on 5 items, against JAX's;
    then the conditioned model's log_prob on a few subsets."""
    jmodel = jdpp.random_kron(jax.random.PRNGKey(3), (10, 12)).rescale(10.0)
    if kind == "dense":
        jmodel = jdpp.from_kernel(jmodel.dense_kernel())
    model = _port(jmodel)
    A = [100, 3, 57, 14, 3, 88]
    cond, jcond = model.condition(A), jmodel.condition(A)
    assert cond.N == 115 and type(cond) is dpp.Dense
    L = cond.L.numpy()
    np.testing.assert_allclose(L, np.asarray(jcond.L), atol=1e-5)
    np.testing.assert_array_equal(L, L.T)
    batch, jbatch = _batch(_subsets(np.random.default_rng(1), 115, 16, 6))
    np.testing.assert_allclose(cond.log_prob(batch).numpy(),
                               np.asarray(jcond.log_prob(jbatch)),
                               rtol=1e-4, atol=1e-4)
