"""Checkpoints of the PyTorch port (``repro_torch.checkpoint``) and resumed
fits, against the JAX package's manager and engine.

* The manager cases of ``tests/test_checkpoint.py`` (round trip, latest
  step and retention, async save, no partial commit) on torch trees. The
  LM-trainer and data-pipeline cases wait for their modules' port.
* A ``LearnerState`` flattens in the JAX pytree's leaf order (params...,
  sweep, key, sched.t, sched.a, sched.backtracks, ll) with the key as its
  uint32 words, so both packages write the same files for the same fit:
  the same leaf count, dtypes and shapes, keys and counters equal, floats
  within the fits' tolerance.
* A resumed fit equals the one-shot fit: on the CPU bit for bit within
  the port (the same float32 operations in the same order), and, across
  the packages, a JAX-written checkpoint resumed by the port matches the
  JAX one-shot fit within the engine tests' rtol = atol = 1e-4 (LLs) and
  1e-4 (factors): the minibatch keys are the same bits since the PRNG
  twin.
"""

import json
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

from repro.checkpoint import CheckpointConfig as JaxCheckpointConfig
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core import SubsetBatch as JaxSubsetBatch
from repro.core import random_krondpp as jax_random_krondpp
from repro.core import sample_krondpp as jax_sample_krondpp
from repro.learning import fit as jax_fit
from repro.learning import schedules as jax_schedules
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.convert import factors_to_numpy, subset_batch_from_numpy
from repro_torch.learning import LearnerState, fit, schedules

TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(v=0.0):
    return {"a": torch.full((4, 3), v), "nested": {"b": torch.arange(5) + v}}


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


@pytest.fixture(scope="module")
def jinit():
    return jax_random_krondpp(jax.random.PRNGKey(3), (4, 5))


@pytest.fixture(scope="module")
def init(jinit):
    return tuple(torch.from_numpy(np.array(f)) for f in jinit.factors)


# ---------------------------------------------------------------------------
# The manager (ports of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    mgr.save(10, _tree(1.0))
    out = mgr.restore(10, target=_tree())
    np.testing.assert_allclose(out["a"], np.full((4, 3), 1.0))
    np.testing.assert_allclose(out["nested"]["b"], np.arange(5) + 1.0)
    assert isinstance(out["a"], torch.Tensor)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2,
                                             async_save=False))
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert mgr.latest_step() == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]                    # retention pruned 1, 2


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True))
    mgr.save(7, _tree(7.0))
    mgr.wait()
    assert mgr.latest_step() == 7
    out = mgr.restore(7, target=_tree())
    np.testing.assert_allclose(out["a"], np.full((4, 3), 7.0))


def test_no_partial_commit(tmp_path):
    """A .tmp directory must never be visible as a committed step."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    os.makedirs(tmp_path / "step_99.tmp")      # simulated crash mid-write
    assert mgr.latest_step() is None
    mgr.save(1, _tree())
    assert mgr.latest_step() == 1


def test_save_snapshots_the_tensors_when_called(tmp_path):
    """The host copy is taken at ``save``: changing the tensor afterwards,
    before the writer thread runs, does not reach the file."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True))
    tree = _tree(2.0)
    mgr.save(3, tree)
    tree["a"].fill_(-1.0)
    mgr.wait()
    np.testing.assert_allclose(mgr.restore(3)["a"], np.full((4, 3), 2.0))


def test_restore_without_target_and_missing_checkpoint(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    assert mgr.should_save(200) and not mgr.should_save(150)
    mgr.emergency_save(5, {"x": [torch.ones(2), np.zeros(3, np.int32)]})
    out = mgr.restore()
    assert isinstance(out["x"][0], np.ndarray)
    np.testing.assert_array_equal(out["x"][1], np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(target={"x": [torch.ones(2)]})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dict_checkpoints_cross_packages(tmp_path, writer):
    """A dict tree written by one package restores in the other."""
    jtree = {"a": jnp.full((4, 3), 3.0), "nested": {"b": jnp.arange(5)}}
    ttree = {"a": torch.full((4, 3), 3.0),
             "nested": {"b": torch.arange(5, dtype=torch.int32)}}
    if writer == "jax":
        JaxCheckpointManager(JaxCheckpointConfig(
            str(tmp_path), async_save=False)).save(4, jtree)
        out = CheckpointManager(CheckpointConfig(str(tmp_path))).restore(
            target=_tree())
        np.testing.assert_array_equal(out["a"], ttree["a"])
        np.testing.assert_array_equal(out["nested"]["b"], np.arange(5))
    else:
        CheckpointManager(CheckpointConfig(
            str(tmp_path), async_save=False)).save(4, ttree)
        out = JaxCheckpointManager(JaxCheckpointConfig(
            str(tmp_path))).restore()
        np.testing.assert_array_equal(out["a"], np.asarray(jtree["a"]))
        np.testing.assert_array_equal(out["nested"]["b"], np.arange(5))
    meta = json.loads((tmp_path / "step_4" / "meta.json").read_text())
    assert meta["n_leaves"] == 2 and json.loads(meta["tree"]) == \
        {"a": None, "nested": {"b": None}}


def test_generator_leaf_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(11)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    mgr.save(1, {"g": g})
    want = torch.rand(6, generator=g)
    other = torch.Generator().manual_seed(0)
    out = mgr.restore(target={"g": other})
    assert out["g"] is other
    assert torch.equal(torch.rand(6, generator=other), want)


# ---------------------------------------------------------------------------
# LearnerState leaves and resumed fits
# ---------------------------------------------------------------------------

STOCH = dict(algorithm="krk-stochastic", minibatch_size=8, seed=5)


def test_learner_state_flattens_in_the_jax_leaf_order(tmp_path, data, init,
                                                      jdata, jinit):
    """Both packages' 4-sweep stochastic fits write the same files."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    fit(init, data, iters=4, checkpoint_dir=str(port_dir), save_every=2,
        schedule=schedules.inv_sqrt(1.0), device="cpu", **STOCH)
    jax_fit(jinit, jdata, iters=4, checkpoint_dir=str(jax_dir),
            save_every=2, schedule=jax_schedules.inv_sqrt(1.0), **STOCH)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == \
        ["step_2", "step_4"]
    for step in ("step_2", "step_4"):
        mp = json.loads((port_dir / step / "meta.json").read_text())
        mj = json.loads((jax_dir / step / "meta.json").read_text())
        assert (mp["n_leaves"], mp["tree"]) == (mj["n_leaves"], mj["tree"]) \
            == (8, None)
        for i in range(8):
            a = np.load(port_dir / step / f"arr_{i}.npy")
            b = np.load(jax_dir / step / f"arr_{i}.npy")
            assert (a.dtype, a.shape) == (b.dtype, b.shape), i
            if i in (2, 3, 4, 5, 6):      # sweep, key, t, a, backtracks
                np.testing.assert_array_equal(a, b)
            else:                         # L1, L2, ll
                np.testing.assert_allclose(a, b, **TOL)


def test_learner_state_unflatten_restores_every_leaf(data, init):
    rep = fit(init, data, iters=2, device="cpu", **STOCH)
    st = rep.state
    back = LearnerState.tree_unflatten(
        [np.array(x) if not isinstance(x, torch.Tensor) else x.numpy()
         for x in st.tree_flatten()], st)
    for a, b in zip(back.tree_flatten(), st.tree_flatten()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back.key.dtype == torch.int64
    with pytest.raises(ValueError, match="leaves"):
        LearnerState.tree_unflatten(st.tree_flatten()[:-1], st)


def test_checkpoint_resume_roundtrip(data, init, tmp_path):
    """Port of tests/test_learning_engine.py::test_checkpoint_resume_roundtrip."""
    ck = str(tmp_path / "ck")
    kw = dict(STOCH, schedule=schedules.inv_sqrt(1.0), device="cpu")
    fit(init, data, iters=4, checkpoint_dir=ck, save_every=2, **kw)
    resumed = fit(init, data, iters=8, checkpoint_dir=ck, resume=True,
                  save_every=2, **kw)
    oneshot = fit(init, data, iters=8, **kw)
    assert resumed.sweeps == 8
    assert resumed.ll_sweeps[0] == 5   # continued, not restarted
    np.testing.assert_allclose(resumed.model.factors[0],
                               oneshot.model.factors[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resumed.model.factors[1],
                               oneshot.model.factors[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        resumed.log_likelihoods, oneshot.log_likelihoods[5:],
        rtol=1e-5, atol=1e-4)
    assert sorted(os.listdir(ck)) == ["step_4", "step_6", "step_8"]


def test_jax_checkpoint_resumed_by_port(data, init, jdata, jinit, tmp_path):
    """The JAX fit writes the 4-sweep checkpoint; the port resumes it to 8
    sweeps and matches the JAX one-shot 8-sweep fit."""
    ck = str(tmp_path / "ck")
    jax_fit(jinit, jdata, iters=4, checkpoint_dir=ck, save_every=2,
            schedule=jax_schedules.inv_sqrt(1.0), **STOCH)
    resumed = fit(init, data, iters=8, checkpoint_dir=ck, resume=True,
                  save_every=2, schedule=schedules.inv_sqrt(1.0),
                  device="cpu", **STOCH)
    oneshot = jax_fit(jinit, jdata, iters=8,
                      schedule=jax_schedules.inv_sqrt(1.0), **STOCH)
    assert resumed.sweeps == 8 and resumed.ll_sweeps == [5, 6, 7, 8]
    np.testing.assert_allclose(resumed.log_likelihoods,
                               oneshot.log_likelihoods[5:], **TOL)
    for g, w in zip(factors_to_numpy(resumed.model), oneshot.model.factors):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    np.testing.assert_array_equal(np.asarray(resumed.state.key),
                                  np.asarray(oneshot.state.key))
    assert float(resumed.state.sched.t) == float(oneshot.state.sched.t)


@pytest.mark.parametrize("case", ["em", "joint", "krk-armijo-dense",
                                  "krk-generator"])
def test_resumed_fit_equals_the_one_shot_fit(data, init, jinit, tmp_path,
                                             case):
    """3 sweeps saved every 2, resumed to 5, against one 5-sweep fit: the
    same state bit for bit, the schedule carry included (an Armijo fit
    that restarted ``a`` at a0 would differ)."""
    model, kw = init, dict(device="cpu")
    if case == "em":
        model = np.array(jinit.full_matrix())
        kw = dict(kw, algorithm="em", a=1e-3)
    elif case == "joint":
        kw = dict(kw, algorithm="joint")
    elif case == "krk-armijo-dense":
        kw = dict(kw, use_dense_theta=True,
                  schedule=schedules.armijo(a0=64.0, max_backtracks=12))

    def gen_kw():
        if case != "krk-generator":
            return {}
        return dict(algorithm="krk-stochastic", minibatch_size=8,
                    generator=torch.Generator().manual_seed(4))

    ck = str(tmp_path / "ck")
    fit(model, data, iters=3, checkpoint_dir=ck, save_every=2, **kw,
        **gen_kw())
    assert sorted(os.listdir(ck)) == ["step_2", "step_3"]
    resumed = fit(model, data, iters=5, checkpoint_dir=ck, save_every=2,
                  resume=True, **kw, **gen_kw())
    oneshot = fit(model, data, iters=5, **kw, **gen_kw())
    assert resumed.ll_sweeps == [4, 5]
    assert resumed.log_likelihoods == oneshot.log_likelihoods[4:]
    for a, b in zip(resumed.state.tree_flatten(),
                    oneshot.state.tree_flatten()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if case == "krk-armijo-dense":
        assert int(resumed.state.sched.backtracks) > 0


def test_resume_with_nothing_committed_starts_at_sweep_zero(data, init,
                                                           tmp_path):
    ck = str(tmp_path / "empty")
    rep = fit(init, data, iters=2, checkpoint_dir=ck, resume=True,
              device="cpu")
    assert rep.ll_sweeps == [0, 1, 2] and rep.sweeps == 2
    assert sorted(os.listdir(ck)) == ["step_2"]     # saved at the end
    again = fit(init, data, iters=2, checkpoint_dir=ck, resume=True,
                device="cpu")
    assert again.sweeps == 2 and again.ll_sweeps == []
    assert again.sweep_times == []


@pytest.mark.cuda
def test_resumed_fit_on_card_equals_the_one_shot_fit(data, init, tmp_path):
    """On a card: the dense-Θ Armijo fit (partial-trace kernels) resumed
    from a checkpoint against the one-shot fit, and the restored state's
    tensors on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(use_dense_theta=True, schedule=schedules.armijo(a0=1.5),
              device="cuda")
    ck = str(tmp_path / "ck")
    fit(init, data, iters=3, checkpoint_dir=ck, save_every=2, **kw)
    resumed = fit(init, data, iters=5, checkpoint_dir=ck, resume=True,
                  save_every=2, **kw)
    oneshot = fit(init, data, iters=5, **kw)
    assert resumed.state.params[0].is_cuda and resumed.state.key.is_cuda
    for a, b in zip(resumed.model.factors, oneshot.model.factors):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
