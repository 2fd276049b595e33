"""The PyTorch port's examples (``examples/port/``) against the JAX
package's (``examples/``), on the CPU.

Each reference example runs as it stands (``runpy``), and its port's
``run`` function repeats its steps through ``repro_torch`` with
``device="cpu"``:

* ``quickstart``: the same keys give the same 80 draws; ``log_prob``,
  the marginals and the conditioned model's E|Y| within float32
  tolerance; the 10-sweep Armijo fit's LL trajectory within
  ``tests/test_torch_learning.py``'s tolerance; ``map(10)`` equal, or
  parting at a float64 tie of the exact conditional variances
  (``tests/test_torch_greedy_map.py``'s rule).
* ``prune_ffn_dpp`` on the reference's params: the magnitude baseline's
  units equal; the port's MAP on the reference's unit kernel gives the
  reference's picks in order; on its own kernel (the same up to float32
  roundoff) it parts from them only at a float64 tie — every diagonal
  of the normalized similarity kernel is 1 + 1e-4, so the first pick is
  a tie of roundoff; the reconstruction error of the reference's kept
  units equal.

``serve_kv_compaction`` and ``train_dpp_selection`` run as scripts in
``tests/test_torch_examples_cli.py``.
"""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import contextlib
import importlib.util
import io
import runpy
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from test_torch_greedy_map import assert_same_or_tie

ROOT = Path(__file__).resolve().parents[1]
LL_TOL = dict(rtol=1e-4, atol=1e-3)       # test_torch_learning.py's


def port_example(name: str):
    """``examples/port/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", ROOT / "examples" / "port" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    ref = quiet(runpy.run_path, str(ROOT / "examples" / "quickstart.py"))
    port = quiet(port_example("quickstart").run, "cpu")
    return ref, port


def test_quickstart_draws_the_references_samples(quickstart):
    ref, port = quickstart
    batch, jbatch = port["batch"], ref["batch"]
    np.testing.assert_array_equal(batch.indices.numpy(),
                                  np.asarray(jbatch.indices))
    np.testing.assert_array_equal(batch.mask.numpy(), np.asarray(jbatch.mask))
    assert port["true"].N == ref["true"].N == 500
    assert port["true"].expected_size() == pytest.approx(
        float(ref["true"].expected_size()), rel=1e-5)


def test_quickstart_log_prob_and_marginals_match(quickstart):
    ref, port = quickstart
    np.testing.assert_allclose(port["log_prob"], ref["logp"], rtol=1e-5,
                               atol=1e-4)
    want = (float(ref["true"].marginal(0)),
            float(ref["true"].marginal([0, 1])))
    np.testing.assert_allclose(port["marginals"], want, rtol=1e-4)


def test_quickstart_fit_follows_the_references_trajectory(quickstart):
    ref, port = quickstart
    rep = port["fit"]
    assert rep.sweeps == ref["rep"].sweeps == 10
    np.testing.assert_allclose(rep.log_likelihoods, ref["lls"], **LL_TOL)
    assert all(b >= a - 1e-3 for a, b in zip(rep.log_likelihoods,
                                              rep.log_likelihoods[1:]))
    for g, f in zip(port["model"].factors, ref["model"].factors):
        f = np.asarray(f)
        np.testing.assert_allclose(g.numpy(), f, rtol=0,
                                   atol=1e-3 * np.abs(f).max())


def test_quickstart_condition_and_map_match(quickstart):
    ref, port = quickstart
    assert port["cond_N"] == ref["cond"].N == 498
    assert port["cond_expected_size"] == pytest.approx(
        float(ref["cond"].expected_size()), rel=1e-3)
    want = np.asarray(ref["model"].map(10))
    got = port["map"].numpy()
    assert got.dtype == np.int32 and got.shape == (10,)
    L = np.asarray(ref["model"].dense_kernel(), np.float64)
    assert_same_or_tie(L, got, want)


# ---------------------------------------------------------------------------
# prune_ffn_dpp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prune():
    ref = quiet(runpy.run_path, str(ROOT / "examples" / "prune_ffn_dpp.py"))
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref["params"]), "cpu")
    port = quiet(port_example("prune_ffn_dpp").run, params=params,
                 device="cpu")
    return ref, port


def test_prune_magnitude_baseline_keeps_the_references_units(prune):
    ref, port = prune
    assert port["keep"] == ref["keep"] == 64
    np.testing.assert_array_equal(port["mag_idx"], ref["mag_idx"])
    assert port["err_mag"] == pytest.approx(ref["err_mag"], rel=1e-5)


def test_prune_dpp_units_are_the_references_up_to_roundoff_ties(prune):
    ref, port = prune
    L_ref = np.asarray(ref["An"].T @ ref["An"]) + 1e-4 * np.eye(128)
    L_ref = L_ref.astype(np.float32)
    np.testing.assert_allclose(port["kernel"].numpy(), L_ref, rtol=0,
                               atol=1e-5)
    want = np.asarray(ref["units"].map(ref["keep"]))
    # the same kernel: the same picks, in order
    got_on_ref = ops.greedy_map_kdpp(torch.from_numpy(L_ref),
                                     ref["keep"]).numpy()
    np.testing.assert_array_equal(got_on_ref, want)
    np.testing.assert_array_equal(np.sort(want), ref["dpp_idx"])
    # the port's own kernel: a first difference is a tie of roundoff
    got = port["map_picks"].numpy()
    assert len(set(got.tolist())) == ref["keep"]
    np.testing.assert_array_equal(np.sort(got), port["dpp_idx"])
    assert_same_or_tie(L_ref.astype(np.float64), got, want)
    assert port["mse"](ref["dpp_idx"]) == pytest.approx(ref["err_dpp"],
                                                         rel=1e-5)


def test_prune_runs_from_its_own_init():
    """``run`` with the port's own seeded init (the JAX package's params
    up to ``random.normal``'s ulps): finite errors, ``keep`` distinct
    units of each selection."""
    out = quiet(port_example("prune_ffn_dpp").run, device="cpu")
    cfg = smoke_config("qwen2-0.5b")
    for k in ("dpp_idx", "mag_idx"):
        idx = out[k]
        assert len(set(idx.tolist())) == out["keep"] == cfg.d_ff // 2
        assert idx.min() >= 0 and idx.max() < cfg.d_ff
    assert np.isfinite([out["err_dpp"], out["err_mag"]]).all()
