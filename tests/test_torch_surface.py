"""The rest of the JAX package's public surface in the PyTorch port: the
deprecated ``core.fit_*`` and ``sample_krondpp_batch`` delegates, the
``repro.sampling`` top-level shims and ``compile_cache_size``, the
single-sample phase-2 compat surface of ``sampling/batched.py``, the
``launch`` exports, and the rank hash-seed check of
``launch.mesh.make_mesh_from_devices``.

Each delegate is held against the JAX package's on the same numpy inputs
and keys: the warning's category and text (``repro.`` read as
``repro_torch.``), and the results — LL trajectories within float32
tolerance (``tests/test_torch_learning.py``'s, ``test_torch_em.py``'s and
``test_torch_picard.py``'s), picks equal or parting at a proven roundoff
tie (``tests/test_torch_phase2.py``'s rule), keyed rows equal.
"""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch as jlaunch
import repro.sampling as jsampling
from repro.core import SubsetBatch as JaxSubsetBatch
from repro.core import random_krondpp as jax_random_krondpp
from repro.core import sample_krondpp as jax_sample_krondpp
from repro.sampling import SpectralCache as JaxSpectralCache
from repro.sampling import batched as jbatched
import repro_torch.core as core
import repro_torch.launch as launch
import repro_torch.sampling as sampling
from repro_torch import random as prng
from repro_torch.convert import (factors_to_numpy, spectrum_from_numpy,
                                 subset_batch_from_numpy)
from repro_torch.core import KronDPP
from repro_torch.kernels.phase2_select import canonical_pair
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sampling import batched as tb
from repro_torch.sampling import kdpp as tk
from test_torch_phase2 import assert_same_picks

ROOT = Path(__file__).resolve().parents[1]
LL_TOL = dict(rtol=1e-4, atol=1e-3)       # test_torch_learning.py's
FACTOR_TOL = dict(rtol=1e-4, atol=1e-4)
EM_REL = 2e-4                             # test_torch_em.py's MODEL_REL
JOINT_REL = 5e-4                          # test_torch_picard.py's


@pytest.fixture(scope="module")
def jdata():
    """50 host draws from a (4, 5) KronDPP (numpy seed 2, key 7), as the
    learning tests make them."""
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


def tinit(seed: int) -> KronDPP:
    return KronDPP(tuple(torch.from_numpy(np.array(f))
                         for f in jinit(seed).factors))


def warned(fn, *args, **kwargs):
    """(fn's result, the one DeprecationWarning it raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in caught]
    return out, dep[0]


def assert_same_warning(got, want, drop: str = ""):
    """The port's warning is the JAX package's, ``repro.`` read as
    ``repro_torch.`` (and ``drop`` taken out of the JAX text), raised at
    the caller's line."""
    assert got.category is want.category is DeprecationWarning
    text = str(want.message).replace("repro.", "repro_torch.")
    assert str(got.message) == text.replace(drop, "")
    assert got.filename == __file__ == want.filename


# ---------------------------------------------------------------------------
# core: the deprecated fit functions and sample_krondpp_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"use_dense_theta": True}, {"fresh_theta": False},
    {"minibatch_size": 16, "seed": 5}],
    ids=["krk", "dense_theta", "stale_theta", "krk_stochastic"])
def test_fit_krk_picard_delegates_as_the_reference(data, jdata, kw):
    """``fit_krk_picard`` warns and fits through ``learning.fit`` on the
    reference's route: batch KrK-Picard, or ``"krk-stochastic"`` when
    ``minibatch_size`` is set, whose minibatches come from the seed's key
    stream as the JAX engine's do."""
    res, w = warned(core.fit_krk_picard, tinit(3), data, iters=4, a=1.0,
                    device="cpu", **kw)
    jres, jw = warned(jcore.fit_krk_picard, jinit(3), jdata, iters=4,
                      a=1.0, **kw)
    assert_same_warning(w, jw)
    assert isinstance(res, core.krk_picard.FitResult)
    assert isinstance(res.model, KronDPP)
    assert len(res.log_likelihoods) == len(jres.log_likelihoods) == 5
    assert len(res.step_times) == len(jres.step_times)
    np.testing.assert_allclose(res.log_likelihoods, jres.log_likelihoods,
                               **LL_TOL)
    for g, f in zip(factors_to_numpy(res.model), jres.model.factors):
        np.testing.assert_allclose(g, np.asarray(f), **FACTOR_TOL)


def test_fit_krk_picard_without_ll_tracking(data, jdata):
    res, _ = warned(core.fit_krk_picard, tinit(3), data, iters=2,
                    track_ll=False, device="cpu")
    jres, _ = warned(jcore.fit_krk_picard, jinit(3), jdata, iters=2,
                     track_ll=False)
    assert res.log_likelihoods == jres.log_likelihoods == []
    for g, f in zip(factors_to_numpy(res.model), jres.model.factors):
        np.testing.assert_allclose(g, np.asarray(f), **FACTOR_TOL)


def test_fit_em_delegates_as_the_reference(data, jdata):
    L0 = np.array(jinit(3).full_matrix())
    res, w = warned(core.fit_em, torch.from_numpy(L0), data, iters=4,
                    lr=1e-3, device="cpu")
    jres, jw = warned(jcore.fit_em, jnp.asarray(L0), jdata, iters=4,
                      lr=1e-3)
    assert_same_warning(w, jw)
    assert isinstance(res, core.em.EMResult)
    assert len(res.step_times) == len(jres.step_times)
    np.testing.assert_allclose(res.log_likelihoods, jres.log_likelihoods,
                               rtol=1e-4, atol=1e-4)
    want = np.asarray(jres.L)
    np.testing.assert_allclose(res.L.numpy(), want, rtol=0,
                               atol=EM_REL * np.abs(want).max())


def test_fit_joint_picard_delegates_as_the_reference(data, jdata):
    res, w = warned(core.fit_joint_picard, tinit(3), data, iters=4,
                    device="cpu")
    jres, jw = warned(jcore.fit_joint_picard, jinit(3), jdata, iters=4)
    assert_same_warning(w, jw)
    assert isinstance(res, core.joint_picard.JointResult)
    np.testing.assert_allclose(res.log_likelihoods, jres.log_likelihoods,
                               rtol=1e-4, atol=1e-4)
    for g, f in zip(factors_to_numpy(res.model), jres.model.factors):
        f = np.asarray(f)
        np.testing.assert_allclose(g, f, rtol=0,
                                   atol=JOINT_REL * np.abs(f).max())


@pytest.mark.parametrize("k_max", [None, 12])
def test_sample_krondpp_batch_draws_the_references_rows(k_max):
    """The same key gives the JAX package's subsets, as lists."""
    true = jax_random_krondpp(jax.random.PRNGKey(7), (6, 7))
    key = np.asarray(jax.random.PRNGKey(11))
    rows, w = warned(core.sample_krondpp_batch,
                     prng.as_key(key, "cpu"),
                     KronDPP(tuple(torch.from_numpy(np.array(f))
                                   for f in true.factors)), 24, k_max)
    want, jw = warned(jcore.sample_krondpp_batch, jnp.asarray(key), true,
                      24, k_max)
    assert_same_warning(w, jw)
    assert rows == want


def test_core_exports_every_name_of_the_reference():
    assert set(jcore.__all__) <= set(core.__all__)
    for name in ("fit_krk_picard", "fit_em", "fit_joint_picard",
                 "sample_krondpp_batch"):
        assert callable(getattr(core, name))


# ---------------------------------------------------------------------------
# sampling: the top-level shims, compile_cache_size, the phase-2 compat
# ---------------------------------------------------------------------------

def jspectrum(sizes=(5, 6), seed=4, expected=4.0):
    cache = JaxSpectralCache()
    from repro import dpp as jdpp
    model = jdpp.from_factors(*jax_random_krondpp(
        jax.random.PRNGKey(seed), sizes).factors).rescale(expected, cache)
    return model, model.spectrum(cache)


def tspectrum(jspec):
    return spectrum_from_numpy([np.asarray(x) for x in jspec.lams],
                               [np.asarray(x) for x in jspec.vecs],
                               device="cpu")


def test_sampling_shims_warn_and_draw_the_references_rows():
    """The three top-level names warn as the JAX package's do and return
    what the engine entry points return; the rows equal the JAX rows for
    the same key."""
    jmodel, jspec = jspectrum()
    spec = tspectrum(jspec)
    key = np.asarray(jax.random.PRNGKey(9))
    tkey = prng.as_key(key, "cpu")
    got, w = warned(sampling.sample_krondpp_batched, tkey, spec, 14, 8)
    want, jw = warned(jsampling.sample_krondpp_batched, jnp.asarray(key),
                      jspec, 14, 8)
    assert_same_warning(w, jw)
    raw = tb.sample_krondpp_batched(tkey, spec, 14, 8)
    for g, r, j in zip(got, raw, want):
        assert torch.equal(g, r)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))

    got, w = warned(sampling.sample_kdpp_batched, tkey, spec, 3, 8)
    want, jw = warned(jsampling.sample_kdpp_batched, jnp.asarray(key),
                      jspec, 3, 8)
    assert_same_warning(w, jw)
    assert torch.equal(got, tk.sample_kdpp_batched(tkey, spec, 3, 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    L = np.array(jmodel.dense_kernel())
    got, w = warned(sampling.sample_kdpp_dense, tkey, torch.from_numpy(L),
                    3)
    want, jw = warned(jsampling.sample_kdpp_dense, jnp.asarray(key),
                      jnp.asarray(L), 3)
    assert_same_warning(w, jw, drop=" inside a jit trace")
    assert torch.equal(got, tk.sample_kdpp_dense(tkey, torch.from_numpy(L),
                                                 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compile_cache_size_has_no_cache_to_count():
    assert sampling.compile_cache_size() == tb.compile_cache_size() == -1
    assert isinstance(jsampling.compile_cache_size(), int)


def test_sampling_exports_every_name_of_the_reference():
    assert set(jsampling.__all__) <= set(sampling.__all__)


@pytest.mark.parametrize("sizes", [(12,), (5, 6), (2, 3, 2)])
def test_phase2_select_reference_is_the_references_chain(sizes):
    """One sample's chain rule from factored columns: the JAX package's
    picks (``phase2_select_reference``) for m = 1, 2, 3, on eight keys."""
    _, jspec = jspectrum(sizes, seed=len(sizes))
    k_max = jspec.suggested_k_max()
    lams, vecs = tuple(jspec.lams), tuple(jspec.vecs)
    keys = jax.random.split(jax.random.PRNGKey(200), 8)
    us, Gs, k_eff, _ = jax.jit(jax.vmap(
        lambda k: jbatched._phase1_one(k, lams, vecs, k_max)))(keys)
    want = np.asarray(jax.jit(jax.vmap(
        lambda u, G, ke: jbatched.phase2_select_reference(u, G, sizes, ke)))(
            us, Gs, k_eff))
    for s in range(8):
        us_t = torch.from_numpy(np.array(us[s]))
        Gs_t = tuple(torch.from_numpy(np.array(G[s])) for G in Gs)
        got = tb.phase2_select_reference(us_t, Gs_t, sizes, int(k_eff[s]))
        assert got.dtype == torch.int32 and got.shape == (k_max,)
        G1, Gr = canonical_pair(tuple(G[None] for G in Gs_t))
        assert_same_picks(want[s][None], got.numpy()[None], us_t[None], G1,
                          Gr, f"sizes={sizes} row {s}")


@pytest.mark.parametrize("backend", [None, "reference"])
def test_phase2_select_from_a_key_is_the_references(backend):
    """``phase2_select(key, ...)``: the key's k_max uniforms, bit for bit
    the JAX package's, then one ``ops.phase2_select`` call (the plain
    version for CPU tensors): the JAX package's picks."""
    sizes = (5, 6)
    _, jspec = jspectrum(sizes)
    k_max = jspec.suggested_k_max()
    us, Gs, k_eff, _ = jbatched._phase1_one(
        jax.random.PRNGKey(1), tuple(jspec.lams), tuple(jspec.vecs), k_max)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jbatched.phase2_select(key, Gs, sizes, k_eff,
                                             backend=backend))
    np.testing.assert_array_equal(
        prng.uniform(prng.as_key(np.asarray(key), "cpu"), (k_max,)).numpy(),
        np.asarray(jax.random.uniform(key, (k_max,))))
    Gs_t = tuple(torch.from_numpy(np.array(G)) for G in Gs)
    got = tb.phase2_select(np.asarray(key), Gs_t, sizes, int(k_eff),
                           backend=backend)
    assert got.dtype == torch.int32 and got.shape == (k_max,)
    us_t = torch.from_numpy(np.array(jax.random.uniform(key, (k_max,))))
    G1, Gr = canonical_pair(tuple(G[None] for G in Gs_t))
    assert_same_picks(want[None], got.numpy()[None], us_t[None], G1, Gr,
                      "phase2_select(key)")


# ---------------------------------------------------------------------------
# launch: exports and the rank hash-seed check
# ---------------------------------------------------------------------------

def test_launch_exports_the_mesh_constructors():
    assert launch.__all__ == jlaunch.__all__
    assert launch.make_production_mesh is mesh_mod.make_production_mesh
    assert launch.make_mesh_from_devices is mesh_mod.make_mesh_from_devices


RANK = """
import datetime, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_mesh_from_devices
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=30))
try:
    mesh = make_mesh_from_devices(range(2), (2,), ("data",))
    print("MESH", tuple(mesh.shape), mesh.mesh.tolist())
except RuntimeError as e:
    print("ERROR", e)
    sys.exit(3)
finally:
    dist.destroy_process_group()
"""
HASH_DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def hash_seed_ranks(tmp_path_factory):
    """Two groups of two gloo ranks started together: hash seeds (1, 2)
    and (3, 3). Returns {group: [(exit code, stdout, seconds), ...]};
    a rank still running at the deadline is killed (code None)."""
    work = tmp_path_factory.mktemp("hash_seed")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    groups = {"apart": ("1", "2"), "same": ("3", "3")}
    t0 = time.monotonic()
    procs = {g: [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(work / f"{g}.store")],
        env=dict(env, PYTHONHASHSEED=seed), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r, seed in enumerate(seeds)] for g, seeds in groups.items()}
    out = {}
    for g, ps in procs.items():
        out[g] = []
        for p in ps:
            try:
                text, _ = p.communicate(
                    timeout=max(HASH_DEADLINE_S - (time.monotonic() - t0),
                                0.1))
                code = p.returncode
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                code = None
            out[g].append((code, text, time.monotonic() - t0))
    return out


def test_ranks_with_different_hash_seeds_raise_instead_of_hanging(
        hash_seed_ranks):
    """Ranks started with PYTHONHASHSEED 1 and 2: both raise the
    ``RuntimeError`` naming PYTHONHASHSEED within the deadline."""
    for code, text, seconds in hash_seed_ranks["apart"]:
        assert code == 3, text
        assert "ERROR" in text and "PYTHONHASHSEED" in text, text
        assert seconds < HASH_DEADLINE_S


def test_ranks_with_one_hash_seed_build_the_mesh(hash_seed_ranks):
    for code, text, _ in hash_seed_ranks["same"]:
        assert code == 0, text
        assert "MESH (2,) [0, 1]" in text, text


def test_hash_seed_check_leaves_the_fake_world_alone(monkeypatch):
    """The planner's ``fake`` group runs no gather for the check (its
    collectives move no data), and a world of one runs none either."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun

    def refuse(*args, **kwargs):
        raise AssertionError("the hash-seed check ran a collective")

    monkeypatch.setattr(dist, "all_gather", refuse)
    with dryrun.fake_world(8):
        mesh = launch.make_mesh_from_devices(range(8), (2, 4),
                                             ("data", "model"))
        assert mesh.shape == (2, 4)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert launch.make_mesh_from_devices([0], (1, 1), (
            "data", "model")).shape == (1, 1)
    finally:
        dist.destroy_process_group()
