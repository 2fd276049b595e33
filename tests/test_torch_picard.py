"""Full Picard (``core/picard.py``) and joint Picard
(``core/joint_picard.py``, ``fit(algorithm="joint")``) of the PyTorch port
against the JAX package.

The fixture is ``tests/test_learning.py``'s (4, 5) batch, made by the JAX
package and carried across as numpy arrays; the inits are its
``random_krondpp`` keys. Tolerances:

* one step on the same inputs: rtol 1e-4 with atol 1e-4 (the dense
  Picard update inverts L + I and the subset kernels in float32; joint
  Picard adds a 50-step power iteration);
* four-step fits: LL trajectories within rtol = atol = 1e-4 (the JAX
  engine test's), full Picard's kernel within rtol = atol = 1e-4. Joint
  Picard's factors after three or four sweeps within 5e-4 of max |L_i|:
  each package's float32 factors lie up to 1.7e-4 of max |L_i| from a
  float64 run of the same sweeps (the dense M and the power iteration
  round differently), and the two up to 1.8e-4 apart;
* at 24 x 24 from the paper's random init (``benchmarks/
  paper_fig1_synthetic.py``'s size), where float32 is far coarser: each
  learner's float32 model within 5 times the JAX package's own distance
  from a float64 run of the same sweeps, plus 1e-3 of max |L|.
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
from repro.core.joint_picard import joint_picard_step as jax_joint_step
from repro.core.picard import fit_picard as jax_fit_picard
from repro.core.picard import picard_step as jax_picard_step
from repro.learning import fit as jax_fit
from repro.learning import schedules as jax_schedules
from repro_torch import dpp
from repro_torch.convert import factors_to_numpy, subset_batch_from_numpy
from repro_torch.core import (PicardResult, SubsetBatch, fit_picard,
                              joint_picard_step, picard_step)
from repro_torch.core import em as port_em
from repro_torch.learning import LearningEngine, fit, schedules

TOL = dict(rtol=1e-4, atol=1e-4)
JOINT_REL = 5e-4


def assert_factors_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=JOINT_REL * np.abs(w).max())


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


def jinit(seed: int):
    return jax_random_krondpp(jax.random.PRNGKey(seed), (4, 5))


def factors(seed: int):
    return tuple(torch.from_numpy(np.array(f)) for f in jinit(seed).factors)


def dense(seed: int) -> np.ndarray:
    return np.array(jinit(seed).full_matrix())


# ---------------------------------------------------------------------------
# Full Picard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a", [1.0, 0.5])
def test_picard_step_matches_jax(data, jdata, a):
    L = dense(11)
    got = picard_step(torch.from_numpy(L), data, a)
    want = jax_picard_step(jnp.asarray(L), jdata, a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


def test_fit_picard_matches_jax(data, jdata):
    L = dense(11)
    res = fit_picard(L, data, iters=4, device="cpu")
    jres = jax_fit_picard(jnp.asarray(L), jdata, iters=4)
    assert isinstance(res, PicardResult) and len(res.step_times) == 4
    np.testing.assert_allclose(res.log_likelihoods, jres.log_likelihoods,
                               **TOL)
    np.testing.assert_allclose(res.L.numpy(), np.asarray(jres.L), **TOL)


def test_fit_picard_without_ll_tracking(data):
    res = fit_picard(dense(11), data, iters=2, track_ll=False,
                     device="cpu")
    assert res.log_likelihoods == [] and len(res.step_times) == 2
    assert torch.isfinite(res.L).all()


def test_picard_baseline_ascent(data):
    """Port of tests/test_learning.py::test_picard_baseline_ascent."""
    res = fit_picard(dense(11), data, iters=6, device="cpu")
    assert np.all(np.diff(res.log_likelihoods) > -1e-3)


# ---------------------------------------------------------------------------
# Joint Picard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("power_iters", [50, 5])
def test_joint_picard_step_matches_jax(data, jdata, power_iters):
    L1, L2 = factors(19)
    got = joint_picard_step(L1, L2, data, 1.0, power_iters)
    want = jax_joint_step(*jinit(19).factors, jdata, 1.0, power_iters)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("schedule", ["constant", "inv_sqrt"])
def test_fit_joint_trajectory_matches_jax(data, jdata, schedule):
    rep = fit(factors(3), data, algorithm="joint", iters=4,
              schedule=schedules.by_name(schedule, 1.0), device="cpu")
    jrep = jax_fit(jinit(3), jdata, algorithm="joint", iters=4,
                   schedule=jax_schedules.by_name(schedule, 1.0))
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **TOL)
    assert_factors_close(factors_to_numpy(rep.model), jrep.model.factors)
    assert int(rep.state.sched.backtracks) == 0


def test_joint_picard_runs_and_stays_pd(data):
    """Port of tests/test_learning.py::test_joint_picard_runs_and_stays_pd."""
    rep = fit(factors(19), data, algorithm="joint", iters=4, device="cpu")
    for f in rep.model.factors:
        assert np.linalg.eigvalsh(f.numpy()).min() > 0
    assert rep.log_likelihoods[-1] > rep.log_likelihoods[0] - 0.5


def test_joint_engine_takes_power_iters(data, jdata):
    eng = LearningEngine(algorithm="joint", power_iters=5)
    assert eng.power_iters == 5
    rep = fit(factors(3), data, algorithm="joint", iters=2, power_iters=5,
              device="cpu")
    jrep = jax_fit(jinit(3), jdata, algorithm="joint", iters=2,
                   power_iters=5)
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **TOL)


def test_armijo_rejected_for_joint():
    with pytest.raises(ValueError):
        LearningEngine(algorithm="joint", schedule=schedules.armijo())


def test_kron_fit_joint_returns_a_kron(data, jdata):
    model = dpp.Kron(factors(3), device="cpu")
    rep = model.fit(data, algorithm="joint", iters=3, device="cpu")
    assert isinstance(rep.model, dpp.Kron) and rep.model.sizes == (4, 5)
    from repro import dpp as jax_dpp
    jrep = jax_dpp.Kron(tuple(jinit(3).factors)).fit(
        jdata, algorithm="joint", iters=3)
    assert_factors_close(factors_to_numpy(rep.model), jrep.model.factors)


@pytest.mark.cuda
def test_full_and_joint_picard_on_card_match_cpu(data):
    """On a card: fit_picard and the joint fit against the same fits on
    the CPU (cuSOLVER against LAPACK), within the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = fit_picard(dense(11), data, iters=4, device="cpu")
    card = fit_picard(dense(11), data, iters=4, device="cuda")
    assert card.L.is_cuda
    np.testing.assert_allclose(card.log_likelihoods, cpu.log_likelihoods,
                               **TOL)
    np.testing.assert_allclose(card.L.cpu().numpy(), cpu.L.numpy(), **TOL)
    jc = fit(factors(3), data, algorithm="joint", iters=4, device="cpu")
    jg = fit(factors(3), data, algorithm="joint", iters=4, device="cuda")
    np.testing.assert_allclose(jg.log_likelihoods, jc.log_likelihoods,
                               **TOL)
    assert_factors_close(factors_to_numpy(jg.model),
                         factors_to_numpy(jc.model))


# ---------------------------------------------------------------------------
# float32 at benchmarks/paper_fig1_synthetic.py's size
# ---------------------------------------------------------------------------

def _three_sweeps(learner, factors, batch, mod):
    """3 sweeps of ``learner`` through package ``mod`` ("jax" or "port")
    on float32 or float64 ``factors``: the final model as float64 numpy
    (L1 ⊗ L2 for joint Picard)."""
    if mod == "jax":
        kron, eigh, stepP, stepJ, E = (jnp.kron, jnp.linalg.eigh,
                                       jax_picard_step, jax_joint_step,
                                       jax_em)
        clamp = lambda x: jnp.maximum(x, 1e-6)          # noqa: E731
    else:
        kron, eigh, stepP, stepJ, E = (torch.kron, torch.linalg.eigh,
                                       picard_step, joint_picard_step,
                                       port_em)
        clamp = lambda x: torch.clamp_min(x, 1e-6)      # noqa: E731
    L1, L2 = factors
    if learner == "picard":
        L = kron(L1, L2)
        for _ in range(3):
            L = stepP(L, batch, 1.0)
        return np.asarray(L, np.float64)
    if learner == "joint":
        for _ in range(3):
            L1, L2 = stepJ(L1, L2, batch, 1.0, 50)
        return np.kron(np.asarray(L1, np.float64), np.asarray(L2, np.float64))
    lam, V = eigh(kron(L1, L2))
    lam = clamp(lam)
    for _ in range(3):
        lam = E.m_step_eigvals(E.e_step(lam, V, batch))
        V = E.eigvec_ascent(lam, V, batch, 1e-3)
    V, lam = np.asarray(V, np.float64), np.asarray(lam, np.float64)
    return (V * lam[None, :]) @ V.T


@pytest.fixture(scope="module")
def fig1():
    from repro_torch import random as prng
    true = dpp.random_kron(prng.PRNGKey(0, "cpu"), (24, 24),
                           device="cpu").rescale(10.0)
    rows = [r for r in true.sample(prng.PRNGKey(1, "cpu"), 60,
                                   device="cpu").to_lists() if r]
    init = dpp.random_kron(prng.PRNGKey(2, "cpu"), (24, 24), device="cpu")
    return rows, tuple(f.numpy() for f in init.factors)


@pytest.mark.parametrize("learner", ["picard", "joint", "em"])
def test_float32_error_at_fig1_size_is_the_references(fig1, learner):
    """At 24 x 24 from the paper's random init (L + I of condition 1e5),
    a float32 fit lies 1e-3 to 8e-3 of max |L| from a float64 run of the
    same 3 sweeps in either package, so no 1e-4 tolerance holds between
    two float32 runs there (the card against the CPU in
    ``chip_smoke.py`` phase 19). The port's float32 error is the
    reference's: within 5 times it, plus 1e-3."""
    rows, F = fig1
    batch = SubsetBatch.from_lists(rows, device="cpu")
    exact = _three_sweeps(learner, tuple(torch.from_numpy(f).double()
                                         for f in F), batch, "port")
    port = _three_sweeps(learner, tuple(torch.from_numpy(f) for f in F),
                         batch, "port")
    ref = _three_sweeps(learner, tuple(jnp.asarray(f) for f in F),
                        JaxSubsetBatch.from_lists(rows), "jax")
    scale = np.abs(exact).max()
    port_err = np.abs(port - exact).max() / scale
    ref_err = np.abs(ref - exact).max() / scale
    assert np.isfinite(port).all()
    assert port_err <= 5 * ref_err + 1e-3, (port_err, ref_err)
