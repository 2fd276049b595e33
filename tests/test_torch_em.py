"""EM learning of the PyTorch port (``core/em.py``, ``log_likelihood_eig``,
``fit(algorithm="em")``, ``Dense.fit``) against the JAX package.

The fixture is ``tests/test_learning.py``'s: 50 draws of the host sampler
from a (4, 5) KronDPP (numpy seed 2, key 7), made by the JAX package and
carried across as numpy arrays. EM starts from ``eigh(L0)``, and LAPACK
builds choose eigenvector signs freely, so the step-level tests feed both
packages the same (λ, V) from numpy and compare models V diag(λ) V^T,
λ, log-likelihoods and q, never raw V columns. Tolerances:

* ``e_step``: atol 2e-4. The fixture's subset kernels L_Y reach condition
  number 1.2e4, so a float32 inverse errs by up to about 1.2e4 · 2^-24 ≈
  7e-4 relative; each package's q lies within 1.5e-4 of a float64 q.
* ``m_step_eigvals``: rtol 1e-6 (one clip and one division).
* ``eigvec_ascent``: V diag(λ) V^T within rtol = atol = 1e-4 and
  |Vᵀ V_ref| within 1e-4 of the identity.
* ``log_likelihood_eig``: rtol 1e-5, atol 1e-4.
* four-sweep fits: LL trajectories within rtol = atol = 1e-4 (the JAX
  engine test's); the model within 2e-4 of max |L|, because the
  reference's own float32 model lies 9e-5 of max |L| from a float64 run of
  the same sweeps (the E-step's ill-conditioned inverses).
"""

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

from repro.core import SubsetBatch as JaxSubsetBatch
from repro.core import em as jax_em
from repro.core import random_krondpp as jax_random_krondpp
from repro.core import sample_krondpp as jax_sample_krondpp
from repro.learning import fit as jax_fit
from repro.learning import log_likelihood_eig as jax_ll_eig
from repro_torch import dpp
from repro_torch.convert import subset_batch_from_numpy
from repro_torch.core import em
from repro_torch.core.dpp import log_likelihood
from repro_torch.learning import (LearningEngine, fit, log_likelihood_eig,
                                  schedules)

LL_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_REL = 2e-4


@pytest.fixture(scope="module")
def jdata():
    rng = np.random.default_rng(2)
    true = jax_random_krondpp(jax.random.PRNGKey(7), (4, 5))
    subs = [s for s in (jax_sample_krondpp(rng, true) for _ in range(50))
            if s]
    return JaxSubsetBatch.from_lists(subs, k_max=max(len(s) for s in subs))


@pytest.fixture(scope="module")
def data(jdata):
    return subset_batch_from_numpy(np.asarray(jdata.indices),
                                   np.asarray(jdata.mask), device="cpu")


def dense_init(seed: int) -> np.ndarray:
    return np.array(jax_random_krondpp(jax.random.PRNGKey(seed),
                                       (4, 5)).full_matrix())


def shared_eig(seed: int):
    """(λ floored at 1e-6, V) of the seed's dense init, from numpy, as
    float32 arrays: both packages start from these bits."""
    lam, V = np.linalg.eigh(dense_init(seed).astype(np.float64))
    return (np.maximum(lam, 1e-6).astype(np.float32),
            V.astype(np.float32))


def t(x):
    return torch.from_numpy(np.array(x))


def model_of(lam, V) -> np.ndarray:
    lam, V = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                         np.float64) for x in (lam, V))
    return (V * lam[None, :]) @ V.T


def assert_models_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_REL * scale)


# ---------------------------------------------------------------------------
# The steps on shared (λ, V)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 23])
def test_e_step_matches_jax(data, jdata, seed):
    lam, V = shared_eig(seed)
    q = em.e_step(t(lam), t(V), data)
    qj = jax_em.e_step(jnp.asarray(lam), jnp.asarray(V), jdata)
    assert q.shape == (data.n, 20)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=0, atol=2e-4)


def test_m_step_eigvals_matches_jax():
    q = np.random.default_rng(0).uniform(0.0, 1.0, (37, 20)) \
        .astype(np.float32)
    q[:, 0] = 1.0                           # clipped at 1 - 1e-6
    q[:, 1] = 0.0                           # clipped at 1e-6
    got = em.m_step_eigvals(t(q)).numpy()
    want = np.asarray(jax_em.m_step_eigvals(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("lr", [1e-3, 1e-1])
def test_eigvec_ascent_matches_jax(data, jdata, lr):
    lam, V = shared_eig(11)
    Vn = em.eigvec_ascent(t(lam), t(V), data, lr)
    Vj = np.asarray(jax_em.eigvec_ascent(jnp.asarray(lam), jnp.asarray(V),
                                         jdata, lr))
    np.testing.assert_allclose(model_of(lam, Vn), model_of(lam, Vj),
                               rtol=1e-4, atol=1e-4)
    overlap = np.abs(Vn.numpy().astype(np.float64).T @ Vj)
    np.testing.assert_allclose(overlap, np.eye(20), atol=1e-4)
    # the sign fix leaves each column pointing along its V column
    assert ((Vn.numpy() * V).sum(0) > 0).all()


def test_eigvec_ascent_sign_fix_is_convention_free(data):
    """Flipping columns of V flips the same columns of the result, so the
    model does not depend on the eigensolver's sign convention."""
    lam, V = shared_eig(11)
    flip = np.where(np.arange(20) % 3 == 0, -1.0, 1.0).astype(np.float32)
    a = em.eigvec_ascent(t(lam), t(V), data, 1e-2)
    b = em.eigvec_ascent(t(lam), t(V * flip[None, :]), data, 1e-2)
    np.testing.assert_allclose(b.numpy(), a.numpy() * flip[None, :],
                               atol=1e-5)


def test_log_likelihood_eig_matches_jax_and_dense(data, jdata):
    lam, V = shared_eig(11)
    got = float(log_likelihood_eig(t(lam), t(V), data))
    want = float(jax_ll_eig(jnp.asarray(lam), jnp.asarray(V), jdata))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    dense = float(log_likelihood(torch.from_numpy(
        model_of(lam, V).astype(np.float32)), data))
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Fits against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "inv_sqrt"])
def test_fit_em_trajectory_matches_jax(data, jdata, schedule):
    L0 = dense_init(3)
    rep = fit(L0, data, algorithm="em", iters=4,
              schedule=schedules.by_name(schedule, 1e-3), device="cpu")
    from repro.learning import schedules as jax_schedules
    jrep = jax_fit(jnp.asarray(L0), jdata, algorithm="em", iters=4,
                   schedule=jax_schedules.by_name(schedule, 1e-3))
    assert rep.ll_sweeps == jrep.ll_sweeps == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    assert_models_close(rep.model.numpy(), jrep.model)
    assert int(rep.state.sched.backtracks) == 0
    assert float(rep.state.sched.a) == pytest.approx(
        float(jrep.state.sched.a), rel=1e-6)


def test_engine_em_matches_host_loop(data):
    """Port of tests/test_learning_engine.py::test_engine_em_matches_host_loop."""
    L0 = torch.from_numpy(dense_init(3))
    rep = fit(L0, data, algorithm="em", iters=4, a=1e-3, device="cpu")
    lam, V = torch.linalg.eigh(L0)
    lam = torch.clamp_min(lam, 1e-6)
    for _ in range(4):
        q = em.e_step(lam, V, data)
        lam = em.m_step_eigvals(q)
        V = em.eigvec_ascent(lam, V, data, 1e-3)
    np.testing.assert_allclose(rep.model.numpy(),
                               ((V * lam[None, :]) @ V.T).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_em_baseline_improves(data):
    """Port of tests/test_learning.py::test_em_baseline_improves."""
    rep = fit(dense_init(11), data, algorithm="em", iters=5, a=1e-3,
              device="cpu")
    assert rep.log_likelihoods[-1] > rep.log_likelihoods[0]


def test_em_e_step_sums_to_subset_size(data):
    """Port of tests/test_learning.py::test_em_e_step_sums_to_subset_size."""
    lam, V = torch.linalg.eigh(torch.from_numpy(dense_init(23)))
    q = em.e_step(torch.clamp_min(lam, 1e-6), V, data)
    np.testing.assert_allclose(q.sum(-1).numpy(),
                               data.sizes().to(torch.float32).numpy(),
                               rtol=1e-2)


def test_armijo_rejected_for_em():
    """Port of tests/test_learning_engine.py::test_armijo_rejected_for_em."""
    with pytest.raises(ValueError):
        LearningEngine(algorithm="em", schedule=schedules.armijo())


def test_em_state_is_lambda_and_V(data):
    rep = fit(dense_init(3), data, algorithm="em", iters=2, a=1e-3,
              device="cpu")
    lam, V = rep.state.params
    assert lam.shape == (20,) and V.shape == (20, 20)
    assert (lam > 0).all() and torch.isfinite(lam).all()
    np.testing.assert_allclose((V.T @ V).numpy(), np.eye(20), atol=1e-5)
    np.testing.assert_allclose(rep.model.numpy(), model_of(lam, V),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def test_dense_fit_defaults_to_em_and_returns_a_dense(data, jdata):
    L0 = dense_init(3)
    rep = dpp.Dense(L0, device="cpu").fit(data, iters=3, a=1e-3,
                                          device="cpu")
    assert isinstance(rep.model, dpp.Dense)
    assert rep.model.device == torch.device("cpu")
    from repro import dpp as jax_dpp
    jrep = jax_dpp.Dense(jnp.asarray(L0)).fit(jdata, iters=3, a=1e-3)
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    assert_models_close(rep.model.L.numpy(), jrep.model.L)
    with pytest.raises(ValueError, match="Kron"):
        dpp.Dense(L0, device="cpu").fit(data, algorithm="krk",
                                        device="cpu")


def test_kron_fit_em_returns_a_dense(data, jdata):
    jinit = jax_random_krondpp(jax.random.PRNGKey(3), (4, 5))
    model = dpp.Kron(tuple(np.asarray(f) for f in jinit.factors),
                     device="cpu")
    rep = model.fit(data, algorithm="em", iters=3, a=1e-3, device="cpu")
    assert isinstance(rep.model, dpp.Dense) and rep.model.N == 20
    from repro import dpp as jax_dpp
    jrep = jax_dpp.Kron(tuple(jinit.factors)).fit(jdata, algorithm="em",
                                                  iters=3, a=1e-3)
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    assert_models_close(rep.model.L.numpy(), jrep.model.L)
    # the dense materialization is guarded, as in the reference
    with pytest.raises(ValueError, match="max_dense"):
        model.fit(data, algorithm="em", iters=1, max_dense=10,
                  device="cpu")


@pytest.mark.cuda
def test_em_fit_on_card_matches_cpu(data):
    """On a card: the same EM fit as on the CPU (cuSOLVER's eigh, QR and
    LU against LAPACK's), LLs within rtol = atol = 1e-4 and the model
    within 2e-4 of max |L|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    L0 = dense_init(3)
    cpu = fit(L0, data, algorithm="em", iters=4, a=1e-3, device="cpu")
    card = fit(L0, data, algorithm="em", iters=4, a=1e-3, device="cuda")
    assert card.model.is_cuda
    np.testing.assert_allclose(card.log_likelihoods, cpu.log_likelihoods,
                               **LL_TOL)
    assert_models_close(card.model.cpu().numpy(), cpu.model.numpy())
