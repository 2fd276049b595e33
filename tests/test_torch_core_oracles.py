"""The PyTorch port's host oracles against the JAX package's: the
brute-force enumeration and the Picard gradient (``core.dpp``), the host
samplers draw for draw under the same numpy seed (``core.sampling``), and
the greedy subset clustering assignment for assignment
(``core.clustering``)."""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

from _hypothesis_compat import hypothesis, st
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KronDPP as JaxKronDPP
from repro.core import SubsetBatch as JaxBatch
from repro.core import clustering as jclustering
from repro.core import dpp as jcore_dpp
from repro.core import random_krondpp as jax_random_krondpp
from repro.core import sampling as jsampling
from repro_torch.convert import subset_batch_from_numpy
from repro_torch.core import KronDPP, clustering
from repro_torch.core import dpp as core_dpp
from repro_torch.core import sampling

DRAWS = 200


def _factors(sizes, seed):
    """Float32 numpy factors of a JAX paper-init KronDPP."""
    krondpp = jax_random_krondpp(jax.random.PRNGKey(seed), sizes)
    return [np.array(f) for f in krondpp.factors]


def test_enumerate_probabilities_matches_jax():
    L = np.kron(*_factors((2, 3), 0)).astype(np.float64)
    want = jcore_dpp.enumerate_probabilities(L)
    for arg in (L, torch.from_numpy(L), torch.from_numpy(L).float()):
        got = core_dpp.enumerate_probabilities(arg)
        assert got.keys() == want.keys()
        tol = 1e-12 if arg.dtype in (np.float64, torch.float64) else 1e-6
        np.testing.assert_allclose([got[Y] for Y in want],
                                   [want[Y] for Y in want], rtol=tol,
                                   atol=tol)
    assert abs(sum(got.values()) - 1.0) < 1e-6


def test_picard_delta_matches_jax():
    L = np.kron(*_factors((3, 4), 1))
    idx = np.asarray([[0, 5, 7], [2, 11, 0], [4, 0, 0]], np.int32)
    mask = np.asarray([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    got = core_dpp.picard_delta(torch.from_numpy(L),
                                subset_batch_from_numpy(idx, mask,
                                                        device="cpu"))
    want = jcore_dpp.picard_delta(jnp.asarray(L),
                                  JaxBatch(jnp.asarray(idx),
                                           jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _draws(fn, seed):
    rng = np.random.default_rng(seed)
    return [fn(rng) for _ in range(DRAWS)]


def test_sample_dpp_and_full_dpp_match_jax_draw_for_draw():
    L = np.kron(*_factors((2, 4), 2)).astype(np.float64)
    L /= 4.0                                      # E|Y| of a few items
    lam, vecs = np.linalg.eigh(L)
    lam = np.maximum(lam, 0.0)
    got = _draws(lambda r: sampling.sample_dpp(r, torch.from_numpy(lam),
                                               torch.from_numpy(vecs)), 3)
    want = _draws(lambda r: jsampling.sample_dpp(r, lam, vecs), 3)
    assert got == want
    assert sum(map(len, got)) > DRAWS             # the draws are not empty
    got = _draws(lambda r: sampling.sample_full_dpp(r, L), 4)
    assert got == _draws(lambda r: jsampling.sample_full_dpp(r, L), 4)
    got_t = _draws(lambda r: sampling.sample_full_dpp(r, torch.from_numpy(L)),
                   4)
    assert got_t == got


@pytest.mark.parametrize("sizes", [(3, 4), (2, 3, 2)], ids=["m2", "m3"])
def test_sample_krondpp_matches_jax_draw_for_draw(sizes):
    """The port's float64 sampler against the reference's, which takes
    the JAX KronDPP's float32 factors as they are."""
    factors = _factors(sizes, 5)
    port = KronDPP(tuple(torch.from_numpy(f) for f in factors))
    ref = JaxKronDPP(tuple(jnp.asarray(f) for f in factors))
    got = _draws(lambda r: sampling.sample_krondpp(r, port), 6)
    want = _draws(lambda r: jsampling.sample_krondpp(r, ref), 6)
    assert got == want
    n = int(np.prod(sizes))
    assert all(len(set(Y)) == len(Y) and all(0 <= i < n for i in Y)
               for Y in got)
    assert sum(map(len, got)) > DRAWS


def test_phase2_select_ignores_column_signs():
    """The picks read only the residual row norms, which do not depend on
    the basis: flipping column signs of V gives the same draws."""
    L = np.kron(*_factors((3, 3), 7)).astype(np.float64)
    _, vecs = np.linalg.eigh(L)
    V = vecs[:, [1, 4, 6, 8]]
    signs = np.asarray([1.0, -1.0, -1.0, 1.0])
    got = _draws(lambda r: sampling._phase2_select(r, V), 8)
    assert got == _draws(lambda r: sampling._phase2_select(r, V * signs), 8)
    assert got == _draws(lambda r: jsampling._phase2_select(r, V), 8)
    assert all(len(Y) == 4 for Y in got)


def _subsets(rng, n_items, n, max_size):
    return [list(rng.choice(n_items, rng.integers(1, max_size + 1),
                            replace=False)) for _ in range(n)]


@pytest.mark.parametrize("order", ["size_desc", "given"])
def test_clustering_matches_jax(order):
    subs = _subsets(np.random.default_rng(0), 100, 60, 12)
    got = clustering.greedy_subset_clustering(subs, z=30, order=order)
    want = jclustering.greedy_subset_clustering(subs, z=30, order=order)
    assert got.assignments == want.assignments
    assert got.unions == want.unions
    assert got.m == want.m and got.memory_nonzeros() == want.memory_nonzeros()
    for i, s in enumerate(subs):
        assert set(s) <= got.unions[got.assignments[i]]


def test_clustering_oversized_subset_raises_as_jax():
    subs = [[0, 1], list(range(50))]
    with pytest.raises(ValueError, match="budget z=10") as got:
        clustering.greedy_subset_clustering(subs, z=10)
    with pytest.raises(ValueError) as want:
        jclustering.greedy_subset_clustering(subs, z=10)
    assert str(got.value) == str(want.value)


@hypothesis.given(z=st.integers(8, 40), seed=st.integers(0, 999))
@hypothesis.settings(max_examples=20, deadline=None)
def test_property_clustering_matches_jax(z, seed):
    subs = _subsets(np.random.default_rng(seed), 60, 25, min(z, 8))
    got = clustering.greedy_subset_clustering(subs, z=z)
    want = jclustering.greedy_subset_clustering(subs, z=z)
    assert got.assignments == want.assignments and got.unions == want.unions
    assert all(len(u) <= z for u in got.unions)
