"""The port's placement seam (``repro_torch.dpp.runtime``) against the JAX
package.

The reference guarantees that a ``Mesh`` reproduces ``Local`` on shared
keys (``tests/test_runtime.py``). Here the port's ``Mesh`` — eight shards
on the CPU, ``devices=["cpu"] * 8`` — is held against the JAX package's
``Local`` on the same keys, on the model of ``tests/test_runtime.py``
(``random_kron(PRNGKey(0), (4, 5)).rescale(4.0)``) with the JAX
eigendecomposition carried across, so that both packages draw from one
spectrum. Tolerances:

* Kronecker and dense draws (DPP, padded, k-DPP), service rows and
  ``ServiceStats``: bit for bit, against the JAX package and against the
  port's own ``Local``;
* ``Host()`` draws: bit for bit (both seed numpy from the key);
* ``LowRank`` draws: the dual chain's batched products may round
  differently with the batch, so a row is held to ``test_torch_lowrank``'s
  tie rule against the JAX draw, not to bitwise equality;
* refusals: the JAX package's exception type and message.

The learner on a mesh is in ``tests/test_torch_distributed.py``."""

import os
import warnings

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro import dpp as jdpp
from repro.sampling import SpectralCache as JaxCache
from repro.serving import AsyncSamplingService as JaxAsync
from repro.serving import ServingConfig as JaxConfig
from repro_torch import dpp, obs
from repro_torch import random as tr
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.convert import key_from_numpy
from repro_torch.core import SubsetBatch
from repro_torch.learning import LearningEngine
from repro_torch.serving import AsyncSamplingService, ServingConfig
from test_torch_keyed import Carried
from test_torch_lowrank import Carried as CarriedDual
from test_torch_lowrank import assert_dual_rows_match, pair
from test_torch_serving import PLAN, WAIT, _carried, _jax_model, _serve

SHARDS = 8


def mesh():
    return dpp.Mesh(axes={"data": SHARDS}, devices=["cpu"] * SHARDS)


def model_pair():
    """The reference's test model, its carried spectrum and the port's
    model on the same factors."""
    jm = _jax_model()
    jspec, tspec = _carried(jm)
    tm = dpp.Kron(tuple(np.asarray(f) for f in jm.factors), device="cpu")
    return jm, jspec, tm, tspec


def tkey(key):
    return key_from_numpy(np.asarray(key), "cpu")


def picks(batch):
    """-1-padded picks of either package's batch, as numpy."""
    idx, mask = (x.cpu() if isinstance(x, torch.Tensor) else x
                 for x in (batch.indices, batch.mask))
    return np.where(np.asarray(mask), np.asarray(idx), -1)


# ---------------------------------------------------------------------------
# Mesh draws == Local draws, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,k", [(1, 64, None), (2, 13, None),
                                      (3, 24, 3)],
                         ids=["dpp64", "padded13", "kdpp24"])
def test_mesh_draws_equal_jax_local_draws(seed, n, k):
    jm, _, tm, tspec = model_pair()
    key = jax.random.PRNGKey(seed)
    want = jm.sample(key, n, k=k)
    rt = mesh()
    got = tm.sample(tkey(key), n, k, rt, cache=Carried(tspec),
                    device="cpu")
    local = tm.sample(tkey(key), n, k, dpp.Local(), cache=Carried(tspec),
                      device="cpu")
    np.testing.assert_array_equal(picks(got), picks(want))
    np.testing.assert_array_equal(picks(got), picks(local))
    if k is None:
        np.testing.assert_array_equal(got.truncated.numpy(),
                                      np.asarray(want.truncated))
    else:
        assert got.truncated is None and (got.sizes() == k).all()


def test_mesh_caches_one_shard_plan_per_sampler_and_counts():
    """One plan per static config (DPP, k-DPP), reused by repeat calls,
    with the JAX package's ``runtime.mesh.*`` counters: keys and pad rows
    of real keys only, the cache's hits and misses."""
    _, _, tm, tspec = model_pair()
    rt = mesh()
    cache = Carried(tspec)
    with obs.use(obs.InMemoryTracker()) as t:
        first = tm.sample(tr.PRNGKey(1, "cpu"), 13, runtime=rt, cache=cache,
                          device="cpu")
        tm.sample(tr.PRNGKey(3, "cpu"), 24, k=3, runtime=rt, cache=cache,
                  device="cpu")
        assert len(rt._mapped_cache) == 2, rt._mapped_cache.keys()
        again = tm.sample(tr.PRNGKey(1, "cpu"), 13, runtime=rt, cache=cache,
                          device="cpu")
    assert len(rt._mapped_cache) == 2
    np.testing.assert_array_equal(picks(first), picks(again))
    assert t.counter_value("runtime.mesh.map_keys_calls") == 3
    assert t.counter_value("runtime.mesh.keys") == 13 + 24 + 13
    assert t.counter_value("runtime.mesh.pad_rows") == 3 + 0 + 3
    assert t.counter_value("runtime.mesh.exec_cache_misses") == 2
    assert t.counter_value("runtime.mesh.exec_cache_hits") == 1
    assert t.snapshot()["gauges"]["runtime.mesh.data_shards"] == SHARDS
    spans = [e for e in t.events if e.get("op") == "runtime.mesh.map_keys"]
    assert len(spans) == 3 and spans[0]["shards"] == SHARDS


def test_default_mesh_axes_take_every_device_and_equal_local():
    _, _, tm, tspec = model_pair()
    rt = dpp.Mesh(devices=["cpu"] * 3)          # {"data": -1}
    assert rt.num_data_shards == 3 and rt.data_axes == ("data",)
    got = tm.sample(tr.PRNGKey(5, "cpu"), 10, runtime=rt,
                    cache=Carried(tspec), device="cpu")
    want = tm.sample(tr.PRNGKey(5, "cpu"), 10, cache=Carried(tspec),
                     device="cpu")
    np.testing.assert_array_equal(picks(got), picks(want))


def test_service_on_a_mesh_equals_the_jax_local_service():
    """Rows, ``ServiceStats`` (with truncations: k_max = 3 is undersized
    on purpose) and every ``service.*`` counter, as in the reference's
    mesh suite; the k-DPP and keyed paths too."""
    jm, _, tm, tspec = model_pair()
    rt = mesh()
    jsvc = jm.service(seed=7, cache=JaxCache(), k_max=3)
    svc_l = tm.service(seed=7, cache=Carried(tspec), k_max=3, device="cpu")
    svc_m = tm.service(seed=7, cache=Carried(tspec), k_max=3, runtime=rt,
                       device="cpu")
    assert svc_m.runtime is rt
    with obs.use(obs.InMemoryTracker()) as t_l:
        rows_l = svc_l.sample(20)
    with obs.use(obs.InMemoryTracker()) as t_m:
        rows_m = svc_m.sample(20)
    assert rows_m == rows_l == jsvc.sample(20)
    assert svc_m.stats == svc_l.stats == jsvc.stats()
    assert svc_m.stats.truncations > 0
    keys = {k for k in t_l.counters if k.startswith("service.")}
    assert keys == {k for k in t_m.counters if k.startswith("service.")}
    for k in sorted(keys):
        assert t_l.counters[k] == t_m.counters[k], k
    assert t_m.counter_value("runtime.mesh.map_keys_calls") > 0
    assert "runtime.mesh.map_keys_calls" not in t_l.counters
    assert svc_m.sample_kdpp(3, 5) == jsvc.sample_kdpp(3, 5)
    row_keys = np.asarray(jax.random.split(jax.random.PRNGKey(9), 11))
    assert svc_m.draw_keyed(row_keys) == jsvc.draw_keyed(row_keys)


def test_async_tier_on_a_mesh_serves_the_jax_tiers_rows():
    """``model.serving(runtime=Mesh)``: each request's rows are the JAX
    tier's for its (tenant, seq) keys, whatever the coalescing."""
    jm, _, tm, tspec = model_pair()
    config = dict(max_batch=8, deadline_ms=20.0)
    order = ["a", "b", "a", "b", "a"]
    jrows, _ = _serve(JaxAsync(jm, JaxConfig(**config),
                               tenants={"a": 2, "b": 1}, seed=3,
                               cache=JaxCache()), PLAN, order)
    svc = tm.serving(ServingConfig(**config), tenants={"a": 2, "b": 1},
                     seed=3, cache=Carried(tspec), runtime=mesh(),
                     device="cpu")
    assert svc.service.runtime.is_mesh
    trows, _ = _serve(svc, PLAN, order)
    assert trows == jrows
    tenant = AsyncSamplingService(tm, tenant_models={"x": tm}, seed=3,
                                  cache=Carried(tspec), runtime=mesh(),
                                  device="cpu")
    try:
        assert tenant._services["x"].runtime.is_mesh
        assert len(tenant.sample(4, tenant="x", timeout=WAIT)) == 4
    finally:
        tenant.close()


def test_lowrank_on_a_mesh_matches_jax_local_under_the_tie_rule():
    """A ``LowRank`` draw on a mesh against the JAX ``Local`` draw: equal
    or a roundoff tie at a CDF boundary (the dual chain's products may
    round with the batch); the k-DPP too. Its spectrum is placed on the
    mesh's first device."""
    jm, jspec, tm, tspec = pair(64, 6, 4, 3.0)
    rt = mesh()
    placed = tm.spectrum(CarriedDual(tspec), runtime=rt)
    assert placed.phi is tspec.phi                 # already on the device
    key = jax.random.PRNGKey(31)
    keys = np.asarray(jax.random.split(key, 13))
    k_max = jspec.suggested_k_max()
    got = tm.sample(tkey(key), 13, runtime=rt, cache=CarriedDual(tspec),
                    device="cpu")
    assert assert_dual_rows_match(picks(jm.sample(key, 13)), picks(got),
                                  keys, jspec, tspec, k_max) == 13
    got_k = tm.sample(tkey(key), 13, k=2, runtime=rt,
                      cache=CarriedDual(tspec), device="cpu")
    assert assert_dual_rows_match(picks(jm.sample(key, 13, k=2)),
                                  picks(got_k), keys, jspec, tspec, 2,
                                  kdpp=True) == 13


# ---------------------------------------------------------------------------
# Host: the numpy oracle, seeded as the JAX package seeds it
# ---------------------------------------------------------------------------

def lists(batch):
    idx, mask = np.asarray(batch.indices), np.asarray(batch.mask)
    return [idx[b][mask[b]].tolist() for b in range(idx.shape[0])]


@pytest.mark.parametrize("family", ["kron", "dense", "lowrank"])
def test_host_draws_equal_jax_host_draws(family):
    jm, _, tm, _ = model_pair()
    if family == "dense":
        jm = jdpp.from_kernel(jm.dense_kernel())
        tm = dpp.from_kernel(np.asarray(jm.L), device="cpu")
    elif family == "lowrank":
        jm, _, tm, _ = pair(24, 5, 1, 2.0)
    key = jax.random.PRNGKey(11)
    want = jm.sample(key, 5, runtime=jdpp.Host())
    got = tm.sample(tkey(key), 5, runtime=dpp.Host(), device="cpu")
    assert got.to_lists() == lists(want)
    assert got.indices.device == torch.device("cpu")


def test_host_refusals_are_the_jax_packages():
    jm, _, tm, _ = model_pair()
    batch = tm.sample(tr.PRNGKey(5, "cpu"), 8, device="cpu")
    with pytest.raises(ValueError, match="k=None"):
        tm.sample(tr.PRNGKey(0, "cpu"), 2, k=2, runtime=dpp.Host(),
                  device="cpu")
    with pytest.raises(ValueError, match="host"):
        tm.fit(batch, iters=1, runtime=dpp.Host(), device="cpu")
    with pytest.raises(ValueError, match="host"):
        tm.service(runtime=dpp.Host(), device="cpu")
    with pytest.raises(ValueError, match="PRNG key"):
        tm.sample(torch.Generator(), 2, runtime=dpp.Host(), device="cpu")
    for call in (lambda: jm.sample(jax.random.PRNGKey(0), 2, k=2,
                                   runtime=jdpp.Host()),
                 lambda: jm.service(runtime=jdpp.Host())):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# guards, shims and resolution
# ---------------------------------------------------------------------------

def test_a_mesh_refuses_a_generator():
    _, _, tm, tspec = model_pair()
    lm = pair(24, 5, 1, 2.0)[2]
    rt = mesh()
    for call in (
            lambda: tm.sample(torch.Generator(), 8, runtime=rt,
                              device="cpu"),
            lambda: tm.sample(torch.Generator(), 8, k=2, runtime=rt,
                              device="cpu"),
            lambda: lm.sample(torch.Generator(), 8, runtime=rt,
                              device="cpu"),
            lambda: lm.sample(torch.Generator(), 8, k=2, runtime=rt,
                              device="cpu"),
            lambda: tm.fit(tm.sample(tr.PRNGKey(1, "cpu"), 16, device="cpu"),
                           iters=1, runtime=rt, device="cpu",
                           generator=torch.Generator())):
        with pytest.raises(ValueError, match="key"):
            call()


def test_backend_and_mesh_shims_warn_and_resolve():
    jm, _, tm, tspec = model_pair()
    with pytest.warns(DeprecationWarning, match="backend= placement"):
        h_shim = tm.sample(tr.PRNGKey(2, "cpu"), 3, backend="host",
                           device="cpu")
    h_rt = tm.sample(tr.PRNGKey(2, "cpu"), 3, runtime=dpp.Host(),
                     device="cpu")
    assert h_shim.to_lists() == h_rt.to_lists()
    with pytest.warns(DeprecationWarning, match="backend= placement"):
        d_shim = tm.sample(tr.PRNGKey(3, "cpu"), 4, backend="device",
                           device="cpu")
    d_rt = tm.sample(tr.PRNGKey(3, "cpu"), 4, device="cpu")
    np.testing.assert_array_equal(picks(d_shim), picks(d_rt))
    with pytest.raises(ValueError, match="backend"):
        tm.sample(tr.PRNGKey(0, "cpu"), 1, backend="gpu", device="cpu")
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="exactly one"):
        tm.sample(tr.PRNGKey(0, "cpu"), 1, backend="device",
                  runtime=dpp.Local(), device="cpu")
    batch = tm.sample(tr.PRNGKey(4, "cpu"), 16, device="cpu")
    rt = dpp.Mesh(axes={"data": 1}, devices=["cpu"])
    with pytest.warns(DeprecationWarning, match="mesh= is deprecated"):
        shim = tm.fit(batch, iters=2, a=1.0, mesh=rt, device="cpu")
    local = tm.fit(batch, iters=2, a=1.0, device="cpu")
    np.testing.assert_allclose(shim.model.factors[0].numpy(),
                               local.model.factors[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(shim.log_likelihoods, local.log_likelihoods,
                               rtol=1e-5, atol=1e-5)
    with pytest.warns(DeprecationWarning), pytest.raises(TypeError,
                                                         match="Mesh"):
        tm.fit(batch, iters=1, mesh=object(), device="cpu")


def test_from_spec_and_resolution_guards():
    rt = dpp.runtime
    assert isinstance(rt.from_spec("local"), dpp.Local)
    assert isinstance(rt.from_spec("host"), dpp.Host)
    assert isinstance(rt.from_spec("mesh"), dpp.Mesh)
    assert isinstance(rt.from_spec(None), dpp.Local)
    passthrough = dpp.Host()
    assert rt.from_spec(passthrough) is passthrough
    with pytest.raises(ValueError, match="unknown runtime"):
        rt.from_spec("tpu-pod")
    assert isinstance(rt.resolve(None), dpp.Local)
    assert rt.default_runtime() == dpp.Local()
    with pytest.warns(DeprecationWarning):
        assert isinstance(rt.resolve("host"), dpp.Host)
    for bad, jbad in (("gpu", "gpu"), (object(), object())):
        with pytest.raises(TypeError, match="runtime="):
            rt.resolve(bad)
        with pytest.raises(TypeError, match="runtime="):
            jdpp.runtime.resolve(jbad)
    assert (dpp.Local().is_mesh, dpp.Host().is_mesh, mesh().is_mesh) == \
        (False, False, True)
    assert repr(dpp.Local()) == "Local()" and repr(mesh()) == \
        "Mesh(axes={'data': 8})"


def test_mesh_layout_and_its_guards():
    with pytest.raises(ValueError, match="devices="):
        dpp.Mesh(axes={"data": 4}, devices=["cpu"] * 3).mesh
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices="):
            dpp.Mesh().num_data_shards      # no card: no device to take
    rt = dpp.Mesh(axes={"data": 2, "model": 2}, devices=["cpu"] * 5)
    assert rt.axis_names == ("data", "model")
    assert rt.data_axes == ("data",) and rt.num_data_shards == 2
    assert rt.mesh.shape == (2, 2) and len(rt.mesh.devices) == 4
    assert repr(rt) == "Mesh(axes={'data': 2, 'model': 2})"
    assert rt.home("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="first data shard"):
        dpp.Mesh(devices=["meta"]).home("cpu")


def test_even_batch_shard_batch_and_replication():
    rt = mesh()
    idx = torch.arange(26, dtype=torch.int32).reshape(13, 2)
    batch = SubsetBatch(idx, idx >= 0, torch.arange(13) % 2 == 0)
    even = rt.even_batch(batch)
    assert even.n == 8 and torch.equal(even.truncated, batch.truncated[:8])
    assert rt.even_batch(even) is even
    with pytest.raises(ValueError, match="cannot be sharded"):
        rt.even_batch(SubsetBatch(idx[:3], idx[:3] >= 0))
    with pytest.raises(ValueError, match="even_batch"):
        rt.shard_batch(batch)
    shards = rt.shard_batch(even)
    assert len(shards) == SHARDS and all(s.n == 1 for s in shards)
    assert torch.equal(torch.cat([s.indices for s in shards]), even.indices)
    assert torch.equal(torch.cat([s.truncated for s in shards]),
                       even.truncated)
    x = torch.ones(3)
    reps = rt.replicate((x, x + 1))
    assert len(reps) == SHARDS and all(r[0] is x for r in reps)
    assert rt.replicate_pinned((x,))[0] is x and rt._pinned[id(x)][0] is x
    for _ in range(rt._PINNED_MAX + 5):
        rt.replicate_pinned((torch.zeros(1),))
    assert len(rt._pinned) == rt._PINNED_MAX
    # two distinct devices ("meta" holds shapes only): one copy a device,
    # pinned, found again by map_keys' operand placement
    two = dpp.Mesh(axes={"data": 2}, devices=["cpu", "meta"])
    meta = torch.device("meta")
    assert two.replicate_pinned((x,))[0] is x
    copy = two._pinned[id(x)][1][meta]
    assert copy.device == meta and two._on(x, meta) is copy
    assert two._on(x, torch.device("cpu")) is x
    assert [r[0].device.type for r in two.replicate((x,))] == ["cpu", "meta"]


def test_runtime_paths_do_not_warn():
    """The runtime= spellings are the non-deprecated surface."""
    _, _, tm, tspec = model_pair()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        tm.sample(tr.PRNGKey(1, "cpu"), 4, runtime=dpp.Local(),
                  device="cpu")
        tm.sample(tr.PRNGKey(2, "cpu"), 2, runtime=dpp.Host(), device="cpu")
        tm.sample(tr.PRNGKey(2, "cpu"), 4, runtime=mesh(), device="cpu")
        tm.fit(tm.sample(tr.PRNGKey(3, "cpu"), 8, device="cpu"), iters=1,
               runtime=dpp.Local(), device="cpu")
        tm.service(cache=Carried(tspec), runtime=dpp.Local(),
                   device="cpu").sample(2)


def test_lowrank_learner_takes_local_and_refuses_a_mesh():
    _, _, tm, _ = pair(24, 5, 1, 2.0)
    batch = tm.sample(tr.PRNGKey(1, "cpu"), 16, device="cpu")
    rep = tm.fit(batch, iters=1, runtime=dpp.Local(), device="cpu")
    assert rep.sweeps == 1
    with pytest.raises(ValueError, match="Local runtime"):
        tm.fit(batch, iters=1, runtime=mesh(), device="cpu")


# ---------------------------------------------------------------------------
# checkpoints: restore(shardings=)
# ---------------------------------------------------------------------------

def test_restore_places_leaves_where_shardings_say(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "tree"),
                                             async_save=False))
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "xs": [torch.ones(2), np.int32(4)]}
    mgr.save(1, tree)
    one = mgr.restore(shardings="cpu")
    assert isinstance(one["w"], torch.Tensor) and one["w"].device.type \
        == "cpu"
    np.testing.assert_array_equal(one["w"].numpy(), tree["w"])
    per = mgr.restore(target=tree, shardings={"w": torch.device("cpu"),
                                              "xs": ["cpu", "cpu"]})
    assert all(isinstance(v, torch.Tensor) for v in (per["w"], *per["xs"]))
    assert int(per["xs"][1]) == 4
    assert isinstance(mgr.restore()["w"], np.ndarray)   # no placement
    with pytest.raises(ValueError, match="2 devices for a tree of 3"):
        mgr.restore(shardings=["cpu", "cpu"])
    eng = LearningEngine()
    state = eng.init_state((torch.eye(2) * 2, torch.eye(3)), device="cpu")
    mgr.save(2, state)
    back = mgr.restore(2, target=state, shardings=torch.device("cpu"))
    for a, b in zip(back.tree_flatten(), state.tree_flatten()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="onto one device"):
        mgr.restore(2, target=state,
                    shardings=["cpu"] * 7 + ["meta"])


@pytest.mark.cuda
def test_mesh_on_the_card_equals_local_and_the_jax_draws():
    """On a card: a ``Mesh`` of four shards on the one card draws the
    ``Local`` rows bit for bit (one phase-2 launch a shard), which are the
    JAX package's on the carried spectrum; a mesh fit on the card stays
    within the reference's tolerance of the ``Local`` fit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.kernels import phase2_select as p2
    jm, _, _, tspec = model_pair()
    dev = torch.device("cuda", torch.cuda.current_device())
    tm = dpp.Kron(tuple(np.asarray(f) for f in jm.factors), device=dev)
    card = Carried(tspec.to(dev))
    rt = dpp.Mesh(axes={"data": 4}, devices=[dev] * 4)
    key = jax.random.PRNGKey(1)
    p2.launches = 0
    got = tm.sample(tkey(key), 13, runtime=rt, cache=card, device=dev)
    assert p2.launches == 4
    local = tm.sample(tkey(key), 13, cache=card, device=dev)
    np.testing.assert_array_equal(picks(got), picks(local))
    np.testing.assert_array_equal(picks(local), picks(jm.sample(key, 13)))
    batch = tm.sample(tr.PRNGKey(4, dev), 32, device=dev)
    init = dpp.Kron(tuple(np.asarray(f) for f in jdpp.random_kron(
        jax.random.PRNGKey(5), (4, 5)).factors), device=dev)
    rl = init.fit(batch, iters=3, a=1.0, device=dev)
    rm = init.fit(batch, iters=3, a=1.0, runtime=rt, device=dev)
    np.testing.assert_allclose(rm.log_likelihoods, rl.log_likelihoods,
                               rtol=2e-5, atol=2e-5)
