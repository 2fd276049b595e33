"""The PyTorch port's ``SamplingService`` and ``repro_torch.dpp`` facade:
coalescing and scatter, batch shapes, seeded determinism, the metric and
span names against the JAX service for the same request sequence, and the
facade's sampling contract."""

import os
import threading

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core import random_krondpp
from repro.sampling import SamplingService as JaxService
from repro.sampling import SpectralCache as JaxCache
from repro_torch import dpp, obs
from repro_torch.convert import kron_from_numpy, subset_batch_to_numpy
from repro_torch.core import KronDPP, random_krondpp as t_random_krondpp
from repro_torch.sampling import SamplingService, SpectralCache
from repro_torch.serving import AsyncSamplingService


def model(seed=0, sizes=(3, 4)):
    gen = torch.Generator().manual_seed(seed)
    return t_random_krondpp(gen, sizes, device="cpu")


def test_service_coalesces_and_scatters():
    m = model()
    cache = SpectralCache()
    svc = SamplingService(m, cache=cache, seed=0, device="cpu")
    t1, t2, t3 = svc.submit(2), svc.submit(3), svc.submit(1)
    r2 = t2.result()                      # one coalesced flush
    assert svc.stats.flushes == 1 and svc.stats.device_calls == 1
    assert svc.stats.samples_drawn == 8   # 6 rounded up to 8
    assert len(t1.result()) == 2 and len(r2) == 3 and len(t3.result()) == 1
    assert t1.done() and t3.done()
    # same seed, same submission pattern: the same rows
    svc_b = SamplingService(m, cache=cache, seed=0, device="cpu")
    u1, u2, u3 = svc_b.submit(2), svc_b.submit(3), svc_b.submit(1)
    svc_b.flush()
    assert (u1.result(), u2.result(), u3.result()) == \
        (t1.result(), r2, t3.result())
    # another seed draws other rows
    svc_c = SamplingService(m, cache=cache, seed=1, device="cpu")
    assert svc_c.sample(6) != t1.result() + r2 + t3.result()
    # services over the same factors share the eigh work
    assert cache.stats()["misses"] == 2


def test_service_round_up_shapes_with_non_pow2_max_batch():
    svc = SamplingService(model(), max_batch=1000, device="cpu")
    assert svc._round_up(600) == 1000          # capped, not 1024
    assert svc._round_up(3) == 4
    assert svc._round_up(1000) == 1000
    assert svc._round_up(1001) == 2000         # multiple of max_batch
    svc = SamplingService(model(), max_batch=24, device="cpu")
    rows = svc.sample(50)                      # 72 rows in 3 calls
    assert len(rows) == 50 and svc.stats.device_calls == 3
    assert svc.stats.samples_drawn == 72


def _drive(svc):
    svc.submit(2), svc.submit(3)
    svc.submit(1).result()
    svc.sample(5)
    svc.sample(40)                             # 64 rows in 3 chunks


def test_metric_and_span_names_match_the_jax_service():
    """The same request sequence against the JAX service and the port's
    emits the same service counters (names and counts), timers, gauges,
    health gauges and span names."""
    jm = random_krondpp(jax.random.PRNGKey(0), (3, 4))
    jt, tt = jax_obs.InMemoryTracker(), obs.InMemoryTracker()
    with jax_obs.use(jt):
        jsvc = JaxService(jm, cache=JaxCache(), seed=0, max_batch=24)
        _drive(jsvc)
    with obs.use(tt):
        tsvc = SamplingService(
            kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu"),
            cache=SpectralCache(), seed=0, max_batch=24, device="cpu")
        _drive(tsvc)
    assert tsvc.stats() == jsvc.stats()
    assert tsvc._metrics.counters == jsvc._metrics.counters
    assert set(tsvc._metrics.observations) == set(jsvc._metrics.observations)
    assert {k: len(v) for k, v in tsvc._metrics.observations.items()} == \
        {k: len(v) for k, v in jsvc._metrics.observations.items()}
    assert set(tsvc._metrics.gauges) == set(jsvc._metrics.gauges)

    def names(tracker, prefix):
        return {k for k in tracker.counters if k.startswith(prefix)} | \
            {k for k in tracker.gauges if k.startswith(prefix)}

    for prefix in ("service.", "spectral_cache.", "health."):
        assert names(tt, prefix) == names(jt, prefix), prefix
    spans = [sorted(e["op"] for e in tr.events if e["name"] == "span")
             for tr in (tt, jt)]
    assert spans[0] == spans[1]
    assert tsvc.stats.health == jsvc.stats.health == "healthy"


@pytest.mark.threaded
def test_concurrent_submitters_each_get_their_rows():
    """More threads than cores, each submitting and resolving: every
    ticket gets exactly its rows and no draw is lost or doubled."""
    import sys
    svc = SamplingService(model(), seed=3, device="cpu")
    out, errors = {}, []

    def worker(i):
        try:
            out[i] = svc.submit(1 + i % 4).result()
        except Exception as e:          # surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert all(len(out[i]) == 1 + i % 4 for i in range(16))
    assert svc.stats.samples_requested == sum(1 + i % 4 for i in range(16))
    assert svc.stats.samples_drawn >= svc.stats.samples_requested


def test_facade_sample_returns_subset_batch_with_provenance():
    gen = torch.Generator().manual_seed(0)
    m = dpp.random_kron(gen, (4, 5), device="cpu").rescale(4.0)
    assert isinstance(m, dpp.Kron) and m.sizes == (4, 5) and m.N == 20
    assert abs(m.expected_size() - 4.0) < 1e-3
    batch = m.sample(gen, 16, device="cpu")
    k_max = m.spectrum().suggested_k_max()
    assert batch.indices.shape == (16, k_max)
    assert batch.indices.dtype == torch.int32
    assert batch.mask.dtype == torch.bool
    assert batch.truncated.shape == (16,) and batch.truncation_count() == 0
    for row in batch.to_lists():
        assert len(set(row)) == len(row) and all(0 <= i < 20 for i in row)
    arrs = subset_batch_to_numpy(batch)
    assert arrs["indices"].shape == (16, k_max)
    assert (arrs["mask"].sum(1) == batch.sizes().numpy()).all()
    # a forced-tiny budget: every row truncated, and the batch says so
    big = dpp.Kron((5.0 * np.eye(3), 5.0 * np.eye(3)), device="cpu")
    clipped = big.sample(gen, 6, k_max=2, device="cpu")
    assert clipped.truncation_count() == 6
    assert big.sample(gen, (2, 3), device="cpu").truncation_count() == 0
    # dense kernels ride the same pipeline (m = 1)
    dense = dpp.from_kernel(big.dense_kernel(), device="cpu")
    assert dense.m == 1 and dense.sample(gen, 4, device="cpu").n == 4
    svc = dpp.from_factors(*big.factors, device="cpu").service(
        seed=0, device="cpu")
    assert len(svc.sample(3)) == 3


@pytest.mark.parametrize("call", [
    lambda m, g: m.serving(tenant_models={"a": m}, runtime=object(),
                           device="cpu"),
    lambda m, g: m.fit(None, algorithm="krk-stochastic", mesh=object(),
                       device="cpu"),
    lambda m, g: m.fit(None, mesh=object(), iters=1, device="cpu"),
    lambda m, g: m.fit(None, runtime=object(), device="cpu"),
    lambda m, g: dpp.from_kernel(m.dense_kernel(), device="cpu").serving(
        runtime=object(), device="cpu"),
    lambda m, g: AsyncSamplingService(m, runtime=object(), device="cpu"),
    lambda m, g: m.serving(runtime=object(), device="cpu"),
    lambda m, g: m.fit(None, checkpoint_dir="ckpt", runtime=object(),
                       device="cpu"),
    lambda m, g: m.serving(config=None, runtime=object(), device="cpu"),
])
def test_operations_not_ported_raise(call):
    m = dpp.Kron(model().factors, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(m, torch.Generator())


def test_service_rejects_what_it_cannot_sample():
    with pytest.raises(TypeError):
        SamplingService(object(), device="cpu")
    svc = SamplingService(KronDPP(model().factors), device="cpu")
    with pytest.raises(ValueError):
        svc.submit(0)


def test_service_stats_contract_matches_the_jax_view():
    """``ServiceStats``: attributes, ``stats()``, ``stats[key]`` (KeyError
    on an unknown key), ``keys()``, ``==`` against another view or a plain
    dict, and the detached constructor ``ServiceStats(flushes=1)`` with its
    TypeErrors — the same calls on both packages' views
    (``tests/test_obs.py``'s contract)."""
    from repro.sampling.service import ServiceStats as JaxStats
    from repro_torch.sampling import ServiceStats
    jm = random_krondpp(jax.random.PRNGKey(0), (3, 4))
    with jax_obs.use(jax_obs.InMemoryTracker()):
        jsvc = JaxService(jm, cache=JaxCache(), seed=3)
        jsvc.sample(5)
    with obs.use(obs.InMemoryTracker()) as t:
        svc = SamplingService(
            kron_from_numpy([np.asarray(f) for f in jm.factors],
                            device="cpu"), cache=SpectralCache(), seed=3,
            device="cpu")
        svc.sample(5)
    for stats, Stats in ((svc.stats, ServiceStats),
                         (jsvc.stats, JaxStats)):
        assert stats.samples_requested == 5 and stats.flushes == 1
        snap = stats()
        assert isinstance(snap, dict) and set(snap) == set(Stats.KEYS)
        assert tuple(stats.keys()) == Stats.KEYS
        assert snap["flushes"] == 1 == stats["flushes"]
        with pytest.raises(KeyError):
            stats["nope"]
        assert stats == stats and stats == snap
        assert stats != {**snap, "flushes": 2}
        assert Stats(flushes=1) == Stats(flushes=1)
        assert Stats(flushes=1) != Stats(flushes=2)
        assert Stats(flushes=1) == {**dict.fromkeys(Stats.KEYS, 0),
                                    "flushes": 1}
        assert Stats(flushes=1).health == "healthy"
        assert stats.health == "healthy"
        with pytest.raises(TypeError, match="unknown ServiceStats field"):
            Stats(bogus=1)
        with pytest.raises(TypeError, match="not both"):
            Stats(obs.InMemoryTracker(), flushes=1)
        assert (stats == object()) is False
    assert svc.stats == jsvc.stats()
    assert ServiceStats(**jsvc.stats()) == jsvc.stats()
    assert repr(ServiceStats(**jsvc.stats())) == repr(jsvc.stats)
    # the process-wide tracker saw the same stream the view reads
    for k in ServiceStats.KEYS:
        assert t.counters.get(f"service.{k}", 0) == svc.stats[k]
