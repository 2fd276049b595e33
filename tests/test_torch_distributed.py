"""The port's sharded learner (``repro_torch.core.distributed`` behind
``fit(runtime=Mesh(...))``) against the JAX package.

On the reference's model and batch (``tests/test_runtime.py``: 32 subsets
of ``random_kron(PRNGKey(0), (4, 5)).rescale(4.0)``, init
``random_kron(PRNGKey(5), (4, 5))``), the port's ``Mesh`` of eight CPU
shards against the JAX package's ``Local`` fit, to the reference's own
tolerances for Mesh against Local:

* constant schedule: factors and log-likelihoods within rtol = atol =
  2e-5, the same sweeps tracked;
* Armijo (a0 = 64, which must backtrack): the SAME accepted step and
  backtrack count, log-likelihoods within rtol 2e-5 / atol 2e-4, ascent
  held, the factors PD;
* the stochastic sweep: each shard's minibatch replayed through the JAX
  package's ``shard_select_no_replace`` on ``fold_in(k_sel, s)`` and its
  ``krk_picard_step``, factors within 1e-4;
* ``shard_select_no_replace`` and the select mode of the threefry hash
  behind it: the JAX function's values bit for bit."""

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
from repro.core.distributed import shard_select_no_replace as jax_select
from repro.core.krk_picard import krk_picard_step as jax_step
from repro_torch import dpp, obs
from repro_torch import random as tr
from repro_torch.core import SubsetBatch
from repro_torch.core.distributed import (make_distributed_krk_step,
                                          shard_select_no_replace)
from repro_torch.kernels.threefry import threefry2x32_plain
from repro_torch.learning import schedules
from test_torch_runtime import SHARDS, mesh, tkey

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_runtime.py, constant
ARMIJO_LL_TOL = dict(rtol=2e-5, atol=2e-4)
REPLAY_TOL = dict(rtol=1e-4, atol=1e-4)   # the stochastic host replay


@pytest.fixture(scope="module")
def problem():
    """(JAX batch, JAX init, port batch, port init) of the reference's
    mesh suite."""
    jm = jdpp.random_kron(jax.random.PRNGKey(0), (4, 5)).rescale(4.0)
    jb = jm.sample(jax.random.PRNGKey(4), 32)
    jinit = jdpp.random_kron(jax.random.PRNGKey(5), (4, 5))
    batch = SubsetBatch(torch.tensor(np.asarray(jb.indices)),
                        torch.tensor(np.asarray(jb.mask)))
    init = dpp.Kron(tuple(np.asarray(f) for f in jinit.factors),
                    device="cpu")
    return jb, jinit, batch, init


def np_(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# shard_select_no_replace and the select mode behind it: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,m", [(0, 4, 2), (1, 1, 1), (2, 10, 10),
                                      (3, 250, 50), (4, 7, 0)])
def test_shard_select_no_replace_equals_jax(seed, n, m):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_select(key, n, m))
    got = shard_select_no_replace(tkey(key), n, m)
    assert got.dtype == torch.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of keys: each key's selection alone (the shards of a sweep)
    keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(jnp.arange(3))
    batched = shard_select_no_replace(tkey(keys), n, m)
    for s in range(3):
        np.testing.assert_array_equal(
            batched[s].numpy(), np.asarray(jax_select(keys[s], n, m)))


def test_shard_select_no_replace_refuses_like_jax():
    with pytest.raises(ValueError, match="without replacement"):
        shard_select_no_replace(tr.PRNGKey(0, "cpu"), 4, 8)
    with pytest.raises(ValueError, match="without replacement"):
        jax_select(jax.random.PRNGKey(0), 4, 8)


@pytest.mark.parametrize("seed,n,m", [(5, 1000, 64), (6, 3, 3)])
def test_select_mode_of_the_plain_hash_equals_jax(seed, n, m):
    """``threefry2x32(keys, n, "select", n2=m)``'s plain version, which
    the kernel's select mode is held to: each row the JAX function's draw
    for that key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    got = threefry2x32_plain(tkey(keys), n, "select", n2=m)
    assert got.dtype == torch.int32 and got.shape == (4, m)
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(jax_select(keys[r], n, m)))
    with pytest.raises(ValueError, match="select"):
        threefry2x32_plain(tkey(keys), 3, "select", n2=4)


@pytest.mark.cuda
def test_select_kernel_matches_plain_on_card():
    """On a card: the select mode of the kernel against the plain version
    on the same keys, bit for bit, and one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from repro_torch.kernels.threefry import threefry2x32_cuda
    for R, n, m in ((1, 1, 1), (4, 250, 50), (8, 4, 2), (3, 5000, 300)):
        keys = tr.split(tr.PRNGKey(R + m, device="cuda"), R)
        before = threefry2x32_cuda.launches
        got = shard_select_no_replace(keys, n, m)
        assert threefry2x32_cuda.launches == before + 1
        want = threefry2x32_plain(keys.cpu(), n, "select", n2=m)
        assert torch.equal(got.cpu(), want), (R, n, m)


# ---------------------------------------------------------------------------
# fits on a mesh against the JAX package's Local fits
# ---------------------------------------------------------------------------

def test_constant_schedule_fit_matches_jax_local(problem):
    jb, jinit, batch, init = problem
    want = jinit.fit(jb, iters=3, a=1.0)
    got = init.fit(batch, iters=3, a=1.0, runtime=mesh(), device="cpu")
    for g, w in zip(got.model.factors, want.model.factors):
        np.testing.assert_allclose(np_(g), np_(w), **TOL)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               **TOL)
    assert got.ll_sweeps == want.ll_sweeps == [0, 1, 2, 3]
    assert isinstance(got.model, dpp.Kron) and got.sweeps == 3


def test_armijo_fit_takes_the_jax_steps(problem):
    jb, jinit, batch, init = problem
    want = jinit.fit(jb, iters=3, schedule=jdpp.schedules.armijo(
        a0=64.0, max_backtracks=12))
    got = init.fit(batch, iters=3, schedule=schedules.armijo(
        a0=64.0, max_backtracks=12), runtime=mesh(), device="cpu")
    assert float(got.state.sched.a) == float(want.state.sched.a)
    assert int(got.state.sched.backtracks) == \
        int(want.state.sched.backtracks) > 0
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               **ARMIJO_LL_TOL)
    lls = np.asarray(got.log_likelihoods)
    assert np.all(np.diff(lls) > -1e-3), lls       # Thm 3.2 ascent held
    for f in got.model.factors:
        assert np.linalg.eigvalsh(np_(f)).min() > 0


def test_stochastic_sweeps_replay_the_jax_shard_chain(problem):
    """Each sweep's per-shard minibatch is the JAX package's
    ``shard_select_no_replace(fold_in(k_sel, s), n_local, mb_local)`` on
    the engine's key chain, replayed through JAX's ``krk_picard_step``."""
    jb, jinit, batch, init = problem
    got = init.fit(batch, algorithm="krk-stochastic", iters=4,
                   minibatch_size=16, seed=2, runtime=mesh(), device="cpu")
    n_local, mb_local = batch.n // SHARDS, 16 // SHARDS
    select = jax.jit(jax.vmap(lambda k, s: jax_select(
        jax.random.fold_in(k, s), n_local, mb_local), in_axes=(None, 0)))
    step = jax.jit(jax_step)
    key = jax.random.PRNGKey(2)
    L1, L2 = jinit.factors
    for _ in range(4):
        key, k_sel = jax.random.split(key)
        sel = np.asarray(select(k_sel, jnp.arange(SHARDS)))
        rows = (np.arange(SHARDS)[:, None] * n_local + sel).reshape(-1)
        L1, L2 = step(L1, L2, JaxBatch(jb.indices[rows], jb.mask[rows]),
                      1.0)
    for g, w in zip(got.model.factors, (L1, L2)):
        np.testing.assert_allclose(np_(g), np_(w), **REPLAY_TOL)
    np.testing.assert_array_equal(tr.key_data(got.state.key),
                                  np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "stale"])
def test_distributed_step_equals_the_one_device_step(problem, fresh):
    """The port's sharded step on eight shards against the JAX package's
    ``krk_picard_step`` on the whole batch, within rtol = atol = 2e-5."""
    jb, jinit, batch, init = problem
    rt = mesh()
    step = make_distributed_krk_step(rt, rt.data_axes, shard_updates=True,
                                     fresh_spectrum=fresh)
    got = step(*init.factors, rt.shard_batch(batch), 0.5)
    want = jax_step(*jinit.factors, jb, 0.5, fresh_theta=fresh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), **TOL)


def test_fit_on_a_mesh_with_a_model_axis_and_metrics(problem):
    """A "model" axis replicates the data shards it sits on (4 data
    shards of 8 devices); a tracked fit emits ``learning.*`` metrics
    tagged runtime="mesh"."""
    jb, jinit, batch, init = problem
    rt = dpp.Mesh(axes={"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert rt.num_data_shards == 4
    with obs.use(obs.InMemoryTracker(keep_records=True)) as t:
        got = init.fit(batch, iters=2, a=1.0, runtime=rt, device="cpu")
    want = jinit.fit(jb, iters=2, a=1.0)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               **TOL)
    assert t.counter_value("learning.sweeps") == 2
    chunks = [r for r in t.records if r["name"] == "learning.chunk_s"]
    assert len(chunks) == 2
    assert all(r["tags"]["runtime"] == "mesh" for r in chunks)
    fits = [e for e in t.events if e.get("name") == "learning.fit"]
    assert fits and fits[-1]["runtime"] == "mesh"


def test_checkpointed_mesh_fit_resumes_to_the_one_shot_fit(problem,
                                                             tmp_path):
    _, _, batch, init = problem
    rt = mesh()
    sched = schedules.armijo(a0=2.0)
    oneshot = init.fit(batch, iters=4, schedule=sched, runtime=rt,
                       device="cpu")
    kw = dict(schedule=sched, runtime=rt, device="cpu", log_every=1,
              checkpoint_dir=str(tmp_path), save_every=1)
    init.fit(batch, iters=2, **kw)
    resumed = init.fit(batch, iters=4, resume=True, **kw)
    assert resumed.ll_sweeps == [3, 4]
    for a, b in zip(resumed.model.factors, oneshot.model.factors):
        assert torch.equal(a, b)
    assert float(resumed.state.sched.a) == float(oneshot.state.sched.a)


@pytest.mark.parametrize("kwargs,match", [
    (dict(algorithm="joint"), "KrK-Picard"),
    (dict(algorithm="em"), "KrK-Picard"),
    (dict(use_dense_theta=True), "dense"),
    (dict(algorithm="krk-stochastic", minibatch_size=64), "minibatches"),
    (dict(algorithm="krk-stochastic", minibatch_size=12), "divide evenly"),
])
def test_mesh_fit_refuses_what_the_jax_mesh_refuses(problem, kwargs, match):
    jb, jinit, batch, init = problem
    with pytest.raises(ValueError, match=match):
        init.fit(batch, iters=1, runtime=mesh(), device="cpu", **kwargs)


def test_mesh_fit_wants_an_even_batch(problem):
    _, _, batch, init = problem
    rt = mesh()
    odd = SubsetBatch(batch.indices[:13], batch.mask[:13])
    with pytest.raises(ValueError, match="even_batch"):
        init.fit(odd, iters=1, runtime=rt, device="cpu")
    assert rt.even_batch(odd).n == 8
    assert init.fit(rt.even_batch(odd), iters=1, runtime=rt,
                    device="cpu").sweeps == 1
