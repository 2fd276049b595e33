"""KrK-Picard learning of the PyTorch port against the JAX package.

The fixture of ``tests/test_learning_engine.py`` — 50 draws of the host
sampler from a (4, 5) KronDPP (numpy seed 2, key 7), init from key 3 — is
made by the JAX package and carried across as numpy arrays
(``convert.subset_batch_from_numpy``). Both packages then run the same
math on the CPU in float32. Tolerances:

* one step, A/C statistics and log-likelihoods: rtol 1e-4 / 1e-3 with a
  small atol, for float32 sums in other orders;
* ``fit`` over 5 sweeps: LL trajectories rtol 1e-4 and atol 1e-3 (the JAX
  engine test's), factors rtol = atol = 1e-4, accepted step sizes and
  backtrack counts equal;
* Appendix-B update against the naive dense update: rtol = atol = 2e-2,
  as in ``tests/test_learning.py`` (the naive side inverts N x N
  matrices in float32).

Minibatches come from a ``torch.Generator`` and differ from
``jax.random.choice``'s, so ``krk-stochastic`` is held against the
port's own ``krk_picard_step`` on the minibatch the same generator state
picks.
"""

import os

# the JAX reference runs on the CPU, never on the card
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.core import SubsetBatch as JaxSubsetBatch
from repro.core import random_krondpp as jax_random_krondpp
from repro.core import sample_krondpp as jax_sample_krondpp
from repro.core.krk_picard import accumulate_AC as jax_accumulate_AC
from repro.core.krk_picard import krk_picard_step as jax_krk_picard_step
from repro.learning import fit as jax_fit
from repro.learning import log_likelihood_factored as jax_ll_factored
from repro.learning import schedules as jax_schedules
import repro_torch.obs as obs
from repro_torch import dpp
from repro_torch.convert import factors_to_numpy, subset_batch_from_numpy
from repro_torch.core import KronDPP, log_likelihood
from repro_torch.core.dpp import masked_inv_and_logdet, theta_matrix
from repro_torch.core.krk_picard import (AC_from_dense_theta, accumulate_AC,
                                         krk_picard_step,
                                         krk_picard_stochastic_step,
                                         theta_matrix_kron)
from repro_torch.kernels.partial_trace import (partial_trace_A_cuda,
                                               partial_trace_C_cuda)
from repro_torch.learning import (LearningEngine, fit,
                                  log_likelihood_factored, schedules,
                                  select_minibatch)

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
LL_TOL = dict(rtol=1e-4, atol=1e-3)
FACTOR_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jdata():
    rng = np.random.default_rng(2)
    true = jax_random_krondpp(jax.random.PRNGKey(7), (4, 5))
    subs = [s for s in (jax_sample_krondpp(rng, true) for _ in range(50))
            if s]
    return JaxSubsetBatch.from_lists(subs, k_max=max(len(s) for s in subs))


@pytest.fixture(scope="module")
def jinit():
    return jax_random_krondpp(jax.random.PRNGKey(3), (4, 5))


@pytest.fixture(scope="module")
def data(jdata):
    return subset_batch_from_numpy(np.asarray(jdata.indices),
                                   np.asarray(jdata.mask), device="cpu")


@pytest.fixture(scope="module")
def init(jinit):
    return tuple(torch.from_numpy(np.array(f)) for f in jinit.factors)


def np_(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# Θ statistics and one step
# ---------------------------------------------------------------------------

def test_AC_routes_agree(data, init):
    """Mirror of tests/test_learning.py::test_AC_routes_agree (port)."""
    L1, L2 = init
    A1, C1 = accumulate_AC(L1, L2, data)
    A2, C2 = AC_from_dense_theta(theta_matrix_kron(L1, L2, data), L1, L2)
    np.testing.assert_allclose(A1, A2, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(C1, C2, rtol=1e-3, atol=1e-4)


def test_accumulate_AC_matches_jax(data, init, jdata, jinit):
    A, C = accumulate_AC(*init, data)
    Aj, Cj = jax_accumulate_AC(*jinit.factors, jdata)
    np.testing.assert_allclose(A, np_(Aj), **STEP_TOL)
    np.testing.assert_allclose(C, np_(Cj), **STEP_TOL)


def _partial_trace_1(M, n1, n2):
    return np.einsum("iaja->ij", M.reshape(n1, n2, n1, n2))


def _partial_trace_2(M, n1, n2):
    return np.einsum("aiaj->ij", M.reshape(n1, n2, n1, n2))


def test_krk_update_matches_naive_dense(data, init):
    """Mirror of tests/test_learning.py::test_krk_update_matches_naive_dense:
    the Appendix-B updates == Tr_i((.)(LΔL)) on the dense kernel, with
    Δ = Θ - (L + I)^{-1} from the port's ``theta_matrix``."""
    L1, L2 = init
    L = torch.kron(L1, L2)
    L1n, L2n = krk_picard_step(L1, L2, data, 1.0)

    def delta(Lk):
        eye = torch.eye(20)
        return theta_matrix(Lk, data) - torch.linalg.solve(Lk + eye, eye)

    X1 = _partial_trace_1(np_(torch.kron(torch.eye(4), torch.linalg.inv(L2).contiguous())
                              @ (L @ delta(L) @ L)), 4, 5) / 5
    np.testing.assert_allclose(L1n, np_(L1) + X1, rtol=2e-2, atol=2e-2)
    Lmid = torch.kron(L1n, L2)
    X2 = _partial_trace_2(np_(torch.kron(torch.linalg.inv(L1n).contiguous(), torch.eye(5))
                              @ (Lmid @ delta(Lmid) @ Lmid)), 4, 5) / 4
    np.testing.assert_allclose(L2n, np_(L2) + X2, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_krk_picard_step_matches_jax(data, init, jdata, jinit, dense, fresh):
    got = krk_picard_step(*init, data, 1.0, use_dense_theta=dense,
                          fresh_theta=fresh)
    want = jax_krk_picard_step(*jinit.factors, jdata, 1.0,
                               use_dense_theta=dense, fresh_theta=fresh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np_(w), **STEP_TOL)


# ---------------------------------------------------------------------------
# Factored objective
# ---------------------------------------------------------------------------

def test_factored_ll_matches_dense(data, init, jdata, jinit):
    """Mirror of tests/test_learning_engine.py::test_factored_ll_matches_dense,
    plus the JAX value."""
    ll_f = float(log_likelihood_factored(init, data))
    ll_dense = float(log_likelihood(torch.kron(*init), data))
    ll_kron = float(KronDPP(init).log_likelihood(data))
    np.testing.assert_allclose(ll_f, ll_dense, **LL_TOL)
    np.testing.assert_allclose(ll_f, ll_kron, **LL_TOL)
    np.testing.assert_allclose(
        ll_f, float(jax_ll_factored(jinit.factors, jdata)), **LL_TOL)


def test_factored_ll_three_factors(data):
    m3 = jax_random_krondpp(jax.random.PRNGKey(5), (2, 2, 5))
    factors = tuple(torch.from_numpy(np.array(f)) for f in m3.factors)
    ll_f = float(log_likelihood_factored(factors, data))
    ll_dense = float(log_likelihood(KronDPP(factors).full_matrix(), data))
    np.testing.assert_allclose(ll_f, ll_dense, **LL_TOL)


def test_non_pd_submatrix_gives_nan_not_an_exception():
    """cholesky_ex mapping: a non-PD block has a NaN logdet and a NaN
    inverse, as jnp.linalg.cholesky gives; a PD block beside it is
    unaffected."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    good = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
    inv, ld = masked_inv_and_logdet(torch.stack([bad, good]))
    assert torch.isnan(ld[0]) and torch.isnan(inv[0]).all()
    np.testing.assert_allclose(ld[1], np.log(1.75), rtol=1e-6)
    np.testing.assert_allclose(inv[1], np.linalg.inv(good.numpy()),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# fit against the JAX engine
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": (schedules.constant(1.0), jax_schedules.constant(1.0)),
    "inv_sqrt": (schedules.inv_sqrt(1.0), jax_schedules.inv_sqrt(1.0)),
    "armijo": (schedules.armijo(a0=2.0), jax_schedules.armijo(a0=2.0)),
}


def assert_fits_agree(rep, jrep, factor_tol=FACTOR_TOL):
    np.testing.assert_allclose(rep.log_likelihoods, jrep.log_likelihoods,
                               **LL_TOL)
    assert rep.ll_sweeps == jrep.ll_sweeps
    for g, w in zip(rep.model.factors, jrep.model.factors):
        np.testing.assert_allclose(g, np_(w), **factor_tol)
    assert float(rep.state.sched.a) == float(jrep.state.sched.a)
    assert int(rep.state.sched.backtracks) == \
        int(jrep.state.sched.backtracks)
    assert rep.sweeps == jrep.sweeps


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fit_matches_jax(data, init, jdata, jinit, name, dense):
    sched, jsched = SCHEDULES[name]
    rep = fit(init, data, iters=5, schedule=sched, use_dense_theta=dense,
              device="cpu")
    jrep = jax_fit(jinit, jdata, iters=5, schedule=jsched,
                   use_dense_theta=dense)
    assert_fits_agree(rep, jrep)


def test_fit_armijo_backtracks_match_jax(data, init, jdata, jinit):
    """Mirror of test_armijo_backtracks_oversized_step: an absurd a0 is
    shrunk — on non-PD candidates, whose LL is NaN, without an exception —
    to the same accepted steps and backtrack counts as in JAX.

    Factors: rtol = atol = 1e-3. The accepted steps here are 4 to 8.8,
    against at most 2 in ``test_fit_matches_jax``, and a step multiplies
    the float32 roundoff of the ascent direction L1·A·L1 − B, which the
    two packages round differently: after one sweep at a = 4 the port is
    2.0e-4 and JAX 4.3e-5 (absolute, on entries up to 4.1) from a float64
    step, and the two differ by up to 7.2e-4 relative over 4 sweeps."""
    rep = fit(init, data, iters=4, device="cpu",
              schedule=schedules.armijo(a0=64.0, max_backtracks=12))
    jrep = jax_fit(jinit, jdata, iters=4,
                   schedule=jax_schedules.armijo(a0=64.0, max_backtracks=12))
    assert int(rep.state.sched.backtracks) > 0
    lls = np.asarray(rep.log_likelihoods)
    assert np.all(np.diff(lls) > -1e-3), lls
    for f in rep.model.factors:
        assert np.linalg.eigvalsh(np_(f)).min() > 0
    assert_fits_agree(rep, jrep, factor_tol=dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("ll_mode,log_every", [("sweep", 2), ("chunk", 2),
                                               ("none", 3)])
def test_fit_ll_modes_and_chunking_match_jax(data, init, jdata, jinit,
                                             ll_mode, log_every):
    rep = fit(init, data, iters=5, log_every=log_every, ll_mode=ll_mode,
              device="cpu")
    jrep = jax_fit(jinit, jdata, iters=5, log_every=log_every,
                   ll_mode=ll_mode)
    assert_fits_agree(rep, jrep)
    assert len(rep.sweep_times) == len(jrep.sweep_times) == \
        -(-5 // log_every)


def test_armijo_halfstep_rejects_a_non_pd_candidate():
    """A step that makes the factor indefinite is rejected through
    lam_min and the NaN LL, and the factor is kept (a_used = 0)."""
    L = torch.eye(2)
    G = torch.tensor([[-4.0, 0.0], [0.0, 0.0]])   # a = 1 -> lam_min = -3
    sched = schedules.armijo(a0=1.0, max_backtracks=1, shrink=0.9)

    def ll_fn(M):
        _, ld = masked_inv_and_logdet(M)
        return ld
    ref = ll_fn(L)
    out, ll, a_used, k = schedules.armijo_halfstep(
        sched, lambda a: L + a * G, ll_fn, ref, torch.tensor(1.0))
    assert torch.isnan(ll_fn(L + G)) and k == 1
    assert float(a_used) == 0.0 and torch.equal(out, L)
    assert float(ll) == float(ref)


# ---------------------------------------------------------------------------
# stochastic sweeps, launches, the facade, validation, health
# ---------------------------------------------------------------------------

def test_stochastic_sweeps_equal_steps_on_the_same_minibatches(data, init):
    rep = fit(init, data, algorithm="krk-stochastic", iters=3,
              minibatch_size=8, a=0.7, seed=1, device="cpu")
    g = torch.Generator().manual_seed(1)
    L1, L2 = init
    for _ in range(3):
        sub = select_minibatch(g, data, 8)
        L1, L2 = krk_picard_stochastic_step(L1, L2, sub, 0.7)
    np.testing.assert_allclose(rep.model.factors[0], L1, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(rep.model.factors[1], L2, rtol=1e-6,
                               atol=1e-6)
    promoted = fit(init, data, algorithm="krk", iters=3, minibatch_size=8,
                   a=0.7, seed=1, device="cpu")
    np.testing.assert_array_equal(promoted.model.factors[0],
                                  rep.model.factors[0])


@pytest.mark.parametrize("fresh,per_sweep_C", [(True, 2), (False, 1)])
def test_dense_route_dispatches_per_sweep(data, init, fresh, per_sweep_C):
    """Per sweep on the dense route: A once, C once per Θ build (twice
    with the block-CCCP refresh, whose L2 half needs only C). On CPU
    tensors every call takes the plain version; no kernel launches."""
    with obs.use(obs.InMemoryTracker()) as t:
        fit(init, data, iters=3, use_dense_theta=True, fresh_theta=fresh,
            schedule=schedules.armijo(a0=2.0), device="cpu")
    assert t.counter_value("kernels.partial_trace_A.reference") == 3
    assert t.counter_value("kernels.partial_trace_C.reference") == \
        3 * per_sweep_C
    assert t.counter_value("kernels.partial_trace_A.cuda") == 0
    assert partial_trace_A_cuda.launches == 0
    assert partial_trace_C_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        fit(init, data, iters=1, use_dense_theta=True, backend="cuda",
            device="cpu")


def test_fit_leaves_the_callers_factors_alone(data, init):
    before = tuple(f.clone() for f in init)
    rep = fit(init, data, iters=2, device="cpu")
    for f, b in zip(init, before):
        assert torch.equal(f, b)
    assert rep.state.params[0].data_ptr() != init[0].data_ptr()


def test_kron_fit_facade_returns_a_port_kron(data, init, jdata, jinit):
    model = dpp.Kron(init, device="cpu")
    rep = model.fit(data, use_dense_theta=True, iters=3, device="cpu")
    assert isinstance(rep.model, dpp.Kron)
    assert rep.model.device == torch.device("cpu")
    jrep = dpp_jax_fit(jinit, jdata)
    for g, w in zip(factors_to_numpy(rep.model), jrep.model.factors):
        np.testing.assert_allclose(g, np_(w), **FACTOR_TOL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dpp.Dense(np.eye(3), device="cpu").fit(data)


def dpp_jax_fit(jinit, jdata):
    from repro import dpp as jax_dpp
    return jax_dpp.Kron(tuple(jinit.factors)).fit(
        jdata, use_dense_theta=True, iters=3)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(algorithm="em"), NotImplementedError),
    (dict(algorithm="joint"), NotImplementedError),
    (dict(algorithm="lowrank"), NotImplementedError),
    (dict(runtime=object()), NotImplementedError),
    (dict(mesh=object()), NotImplementedError),
    (dict(checkpoint_dir="ck"), NotImplementedError),
    (dict(resume=True), NotImplementedError),
    (dict(algorithm="bogus"), ValueError),
    (dict(ll_mode="bogus"), ValueError),
    (dict(algorithm="em", schedule=schedules.armijo()), ValueError),
    (dict(algorithm="em", minibatch_size=8), ValueError),
    (dict(algorithm="krk-stochastic", minibatch_size=99), ValueError),
])
def test_fit_refuses_what_is_not_ported_or_invalid(data, init, kwargs, exc):
    with pytest.raises(exc):
        fit(init, data, iters=1, device="cpu", **kwargs)


def test_engine_validation_matches_jax():
    """Same ValueErrors as the JAX engine for the same bad configs."""
    from repro.learning import LearningEngine as JaxEngine
    for kw in (dict(algorithm="nope"), dict(ll_mode="x"),
               dict(algorithm="krk", minibatch_size=4)):
        with pytest.raises(ValueError):
            JaxEngine(**kw)
        with pytest.raises(ValueError):
            LearningEngine(**kw)


@pytest.mark.parametrize("thresholds", [None, "strict"])
def test_fit_health_verdict_matches_jax(data, init, jdata, jinit,
                                        thresholds):
    """FitReport.health under a tracker (the monitor reads the factors
    through .detach().cpu()) gives the JAX package's verdict and trips."""
    if thresholds == "strict":
        port_h = obs.HealthThresholds(max_log10_condition=-1.0)
        jax_h = jax_obs.HealthThresholds(max_log10_condition=-1.0)
    else:
        port_h = jax_h = None
    with obs.use(obs.InMemoryTracker()) as t:
        rep = fit(init, data, iters=2, log_every=2, health=port_h,
                  device="cpu")
    with jax_obs.use(jax_obs.InMemoryTracker()):
        jrep = jax_fit(jinit, jdata, iters=2, log_every=2, health=jax_h)
    assert rep.health is not None
    assert rep.health["verdict"] == jrep.health["verdict"]
    assert rep.health["worst"] == jrep.health["worst"]
    assert sorted(rep.health["triggered"]) == sorted(jrep.health["triggered"])
    assert "health.psd_margin" in t.gauges
    np.testing.assert_allclose(rep.health["gauges"]["psd_margin"],
                               jrep.health["gauges"]["psd_margin"],
                               rtol=1e-3)


def test_check_learning_reads_tensors_through_cpu():
    mon = obs.HealthMonitor()
    assert mon.check_learning((torch.eye(3), 2.0 * torch.eye(2)), "krk",
                              ll=-1.0) == "healthy"
    assert mon.gauges["min_eigenvalue"] == 1.0
