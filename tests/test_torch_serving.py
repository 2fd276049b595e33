"""The port's async serving tier (``repro_torch.serving``) against the JAX
package's ``repro.serving``.

Covers the queues (``parse_tenants``, ``drain_weighted``: the reference's
outputs on the same inputs), the tier's rows against the JAX tier's for
the same seed and per-tenant order (``AsyncSamplingService``,
``model.serving()`` on ``Kron``, ``Dense`` and ``LowRank``, a ``LowRank``
fleet through ``tenant_models=``), and the reference's contracts of
``tests/test_serving.py`` mirrored on the port: triggers, typed
rejections, shutdown, flush errors, determinism under any coalescing, the
span tree against the sync path, metrics and health per flush.

Tolerances: keys bit for bit; rows equal, or a row whose phase-1 uniform
lies within 1e-6 of its threshold (a different draw, not compared), or a
proven float32 roundoff tie on the exact chain
(``test_torch_keyed.assert_dpp_rows_match``,
``test_torch_lowrank.assert_dual_rows_match``); the port's own rows under
different coalescing: equal, bit for bit; span trees: equal.

Timing: every trigger test is deterministic on a loaded CPU — a deadline
far above the gap between submits (2 s) where the deadline fire is under
test, and a 60 s deadline with ``max_batch`` out of reach where another
fire is; every ``result()`` waits up to 120 s. Sizes: factors 4 x 5, a
low-rank V of 64 x 8 (``tests/test_lowrank.py``'s fleet)."""

import collections
import os
import threading
import time

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
from repro import obs as jax_obs
from repro.sampling import SpectralCache as JaxCache
from repro.serving import AsyncSamplingService as JaxAsync
from repro.serving import ServingConfig as JaxConfig
from repro.serving import ServingStats as JaxServingStats
from repro.serving import parse_tenants as jax_parse_tenants
from repro.serving.keys import TenantKeyring as JaxKeyring
from repro.serving.queues import _TenantState as JaxTenantState
from repro.serving.queues import drain_weighted as jax_drain_weighted
from repro_torch import dpp, obs
from repro_torch import random as tr
from repro_torch.convert import lowrank_from_numpy
from repro_torch.obs.export import is_span_record
from repro_torch.sampling import SpectralCache
from repro_torch.sampling.service import SampleTicket
from repro_torch.serving import (AsyncSamplingService, AsyncTicket,
                                 CancelledRequest, ContinuousBatcher,
                                 QueueFull, RejectedRequest, ServiceClosed,
                                 ServingConfig, ServingStats, parse_tenants)
from repro_torch.serving.queues import _TenantState, drain_weighted
from test_torch_keyed import Carried, assert_dpp_rows_match, padded
from test_torch_lowrank import Carried as CarriedDual
from test_torch_lowrank import assert_dual_rows_match, pair

threaded = pytest.mark.threaded
WAIT = 120.0                  # seconds a ticket may take on a loaded CPU
LONG_MS = 60_000.0            # a deadline no test waits for
DEADLINE_MS = 2_000.0         # far above the gap between two submits


def _model():
    """``tests/test_serving.py``'s model on the port: the same key, so the
    same factors up to float32 roundoff of XᵀX."""
    return dpp.random_kron(tr.PRNGKey(0, "cpu"), (4, 5),
                           device="cpu").rescale(4.0)


def _jax_model():
    return jdpp.random_kron(jax.random.PRNGKey(0), (4, 5)).rescale(4.0)


def _carried(jm):
    """The JAX model's spectrum carried to the port, behind a cache."""
    from repro_torch.convert import spectrum_from_numpy
    jspec = jm.spectrum(JaxCache())
    tspec = spectrum_from_numpy([np.asarray(x) for x in jspec.lams],
                                [np.asarray(x) for x in jspec.vecs],
                                device="cpu")
    return jspec, tspec


def _serve(svc, plan, order):
    """Submit ``plan[tenant][seq]`` rows in ``order`` of tenants; close
    (drain) and return ({tenant: [rows per request]}, {tenant: tickets})."""
    try:
        tickets = collections.defaultdict(list)
        for tenant in order:
            seq = len(tickets[tenant])
            tickets[tenant].append(svc.submit(plan[tenant][seq],
                                              tenant=tenant))
        rows = {t: [tk.result(timeout=WAIT) for tk in tks]
                for t, tks in tickets.items()}
    finally:
        svc.close()
    return rows, tickets


def _assert_rows_match_jax(jrows, trows, tickets, seed, jspec, tspec,
                           k_max, dual=False):
    """Each request's rows against the JAX tier's, on the request's own
    keys (tenant, seq, row) from the JAX keyring."""
    ring = JaxKeyring(seed)
    for tenant, reqs in trows.items():
        for seq, (want, got) in enumerate(zip(jrows[tenant], reqs)):
            t = tickets[tenant][seq]
            assert (t.tenant, t.seq, t.num_samples) == (tenant, seq,
                                                        len(got))
            keys = np.asarray(ring.row_keys([t], t.num_samples))
            label = f"{tenant} seq {seq}"
            if dual:
                assert_dual_rows_match(padded(want, k_max),
                                       padded(got, k_max), keys, jspec,
                                       tspec, k_max)
            else:
                assert_dpp_rows_match(padded(want, k_max), padded(got, k_max),
                                      keys, jspec, tspec, k_max, label)


# ---------------------------------------------------------------------------
# queues: the reference's outputs on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, 0, 3, "a:2,b", " a : 3 , , b:1 ", "x", {"x": 4}, {"p": 1, 7: 2},
    ["p", "q"], ("z", "y", "x")], ids=repr)
def test_parse_tenants_matches_jax(spec):
    got = parse_tenants(spec)
    assert isinstance(got, collections.OrderedDict)
    assert list(got.items()) == list(jax_parse_tenants(spec).items())


@pytest.mark.parametrize("spec", ["a:0", {"x": 0}, "a:-1,b"], ids=repr)
def test_parse_tenants_rejects_like_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jax_parse_tenants(spec)
    with pytest.raises(ValueError) as err:
        parse_tenants(spec)
    assert str(err.value) == str(jerr.value)


class _Req:
    def __init__(self, tenant, n):
        self.tenant = tenant
        self.num_samples = n


def _tenants(cls, spec):
    out = collections.OrderedDict()
    for name, (weight, sizes) in spec.items():
        ts = cls(name, weight)
        for n in sizes:
            ts.queue.append(_Req(name, n))
        out[name] = ts
    return out


@pytest.mark.parametrize("spec,budget", [
    ({"heavy": (2, [1] * 6), "light": (1, [1] * 6)}, 6),
    ({"heavy": (4, [1] * 50), "light": (1, [1] * 2)}, 10),
    ({"a": (1, [4, 4, 4])}, 6),
    ({"a": (3, [1, 2, 3]), "b": (1, [4]), "c": (2, [1, 1, 1, 1])}, 9),
    ({"a": (1, []), "b": (2, [2, 2])}, 100),
    ({"a": (1, [5]), "b": (1, [1])}, 1),
], ids=["heavy2-light1", "starve", "no-split", "three", "empty", "tiny"])
def test_drain_weighted_matches_jax(spec, budget):
    """The same drain order, rows and leftover queues as the reference,
    and its weight-2 interleave, starvation and no-split contracts."""
    got = drain_weighted(_tenants(_TenantState, spec), budget)
    jt = _tenants(JaxTenantState, spec)
    want = jax_drain_weighted(jt, budget)
    assert [(r.tenant, r.num_samples) for r in got] == \
        [(r.tenant, r.num_samples) for r in want]
    left = _tenants(_TenantState, spec)
    drain_weighted(left, budget)
    assert {n: len(s.queue) for n, s in left.items()} == \
        {n: len(s.queue) for n, s in jt.items()}
    order = [r.tenant for r in got]
    if spec == {"heavy": (2, [1] * 6), "light": (1, [1] * 6)}:
        assert order == ["heavy", "heavy", "light", "heavy", "heavy",
                         "light"]
    if "light" in spec and budget == 10:
        assert "light" in order[:5]
    if spec == {"a": (1, [4, 4, 4])}:
        assert [r.num_samples for r in got] == [4, 4]


def test_tenant_state_rejects_weight_zero_like_jax():
    with pytest.raises(ValueError):
        JaxTenantState("t", 0)
    with pytest.raises(ValueError):
        _TenantState("t", 0)


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(deadline_ms=0.0),
                                dict(max_queue_depth=0),
                                dict(default_weight=0)], ids=str)
def test_serving_config_validation(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        ServingConfig(**kw)
    assert ServingConfig() == ServingConfig(max_batch=64, deadline_ms=5.0,
                                            max_queue_depth=256,
                                            default_weight=1)
    assert ServingStats.KEYS == JaxServingStats.KEYS


# ---------------------------------------------------------------------------
# admission control: typed rejections
# ---------------------------------------------------------------------------

def test_queue_full_is_typed_and_structured():
    # huge deadline + huge batch -> nothing fires, the queue holds
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=LONG_MS,
                                max_queue_depth=2), device="cpu")
    try:
        svc.submit(1, tenant="t")
        svc.submit(1, tenant="t")
        with pytest.raises(QueueFull) as exc:
            svc.submit(1, tenant="t")
        err = exc.value
        assert isinstance(err, RejectedRequest)
        assert err.reason == "queue_full"
        assert err.tenant == "t"
        assert err.depth == 2 and err.limit == 2
        assert svc.stats.rejected == 1
        assert svc.per_tenant()["t"] == {"weight": 1, "queued": 2,
                                         "admitted": 2, "rejected": 1}
    finally:
        svc.close()


def test_submit_after_close_raises_service_closed():
    svc = AsyncSamplingService(_model(), ServingConfig(), device="cpu")
    svc.close()
    with pytest.raises(ServiceClosed) as exc:
        svc.submit(1, tenant="late")
    assert exc.value.reason == "closed" and exc.value.tenant == "late"
    svc.close()     # idempotent


# ---------------------------------------------------------------------------
# triggers: deadline, batch, drain, cancel
# ---------------------------------------------------------------------------

@threaded
def test_deadline_fire_coalesces_concurrent_tenants():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=DEADLINE_MS),
        tenants={"a": 1, "b": 1}, device="cpu")
    try:
        ta = svc.submit(3, tenant="a")
        tb = svc.submit(2, tenant="b")
        rows_a = ta.result(timeout=WAIT)
        rows_b = tb.result(timeout=WAIT)
        assert len(rows_a) == 3 and len(rows_b) == 2
        assert all(isinstance(r, list) for r in rows_a + rows_b)
        assert svc.stats.deadline_fires == 1
        assert svc.stats.batch_fires == 0
        # both tenants' rows rode ONE padded device call
        assert svc.service.stats.device_calls == 1
        assert svc.service.stats.samples_drawn == 8
    finally:
        svc.close()


@threaded
def test_batch_fire_preempts_a_long_deadline():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4, deadline_ms=LONG_MS),
        device="cpu")
    try:
        t0 = time.perf_counter()
        tickets = [svc.submit(2) for _ in range(2)]    # 4 rows == max_batch
        for t in tickets:
            assert len(t.result(timeout=WAIT)) == 2
        # resolved far before the 60s deadline could have fired
        assert time.perf_counter() - t0 < LONG_MS / 1e3
        assert svc.stats.batch_fires >= 1
        assert svc.stats.deadline_fires == 0
    finally:
        svc.close()


@threaded
def test_close_drains_pending_tickets():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=LONG_MS),
        device="cpu")
    t = svc.submit(2)
    svc.close(drain=True)
    assert len(t.result(timeout=1.0)) == 2
    assert svc.stats.drain_fires == 1
    assert svc.stats.deadline_fires == 0


@threaded
def test_close_without_drain_cancels_queued_tickets():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=LONG_MS),
        tenants={"a": 1}, device="cpu")
    t = svc.submit(2, tenant="a")
    svc.close(drain=False)
    with pytest.raises(CancelledRequest) as exc:
        t.result(timeout=1.0)
    assert exc.value.reason == "cancelled" and exc.value.tenant == "a"
    assert svc.stats.cancelled == 1
    assert svc.stats.flushes == 0


def wait_for(reached, timeout=WAIT):
    """Poll ``reached()`` until it holds or ``timeout`` seconds pass."""
    end = time.monotonic() + timeout
    while not reached() and time.monotonic() < end:
        time.sleep(0.005)


@threaded
def test_flush_error_fails_its_batch_and_the_loop_keeps_serving():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=20.0),
        device="cpu")
    real = svc.service.draw_keyed
    try:
        calls = {"n": 0}

        def flaky(row_keys):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(row_keys)

        svc.service.draw_keyed = flaky
        bad = svc.submit(2)
        with pytest.raises(RuntimeError, match="injected device failure"):
            bad.result(timeout=WAIT)
        # the flush thread counts a flush after it has resolved or rejected
        # the batch (the reference's order), so a resolved ticket may be
        # seen before its count
        wait_for(lambda: svc.stats.failed_flushes >= 1)
        assert svc.stats.failed_flushes == 1
        # the flush thread survived the failure and serves new traffic
        assert len(svc.sample(3, timeout=WAIT)) == 3
        wait_for(lambda: svc.stats.flushes >= 1)
        assert svc.stats.flushes == 1
    finally:
        svc.service.draw_keyed = real
        svc.close()


# ---------------------------------------------------------------------------
# determinism: batching-invariant draws, the JAX tier's rows
# ---------------------------------------------------------------------------

PLAN = {"a": (3, 1, 2), "b": (2, 2)}


@threaded
def test_fixed_seed_and_tenant_order_reproduce_samples_bit_for_bit():
    # Same seed, same per-tenant submission order — but wildly different
    # coalescing: one deadline flush against per-row batch fires, and the
    # global interleaving across tenants differs. Every sample must match.
    def run(config, order):
        svc = AsyncSamplingService(_model(), config, tenants={"a": 1, "b": 1},
                                   seed=7, device="cpu")
        return _serve(svc, PLAN, order)[0]

    coalesced = run(ServingConfig(max_batch=4096, deadline_ms=DEADLINE_MS),
                    ["a", "b", "a", "b", "a"])
    fragmented = run(ServingConfig(max_batch=1, deadline_ms=5.0),
                     ["b", "a", "a", "b", "a"])
    assert coalesced == fragmented


@threaded
@pytest.mark.parametrize("seed", [0, 7])
def test_async_rows_match_the_jax_tier(seed):
    """The same seed and per-tenant order through both packages' tiers
    (each coalescing as its own thread pleases): the same rows per
    (tenant, seq), on the JAX spectrum carried across."""
    jm = _jax_model()
    jspec, tspec = _carried(jm)
    k_max = jspec.suggested_k_max()
    config = dict(max_batch=8, deadline_ms=20.0)
    order = ["a", "b", "a", "b", "a"]
    jrows, _ = _serve(JaxAsync(jm, JaxConfig(**config),
                               tenants={"a": 2, "b": 1}, seed=seed,
                               cache=JaxCache()), PLAN, order)
    svc = AsyncSamplingService(_model(), ServingConfig(**config),
                               tenants={"a": 2, "b": 1}, seed=seed,
                               cache=Carried(tspec), device="cpu")
    assert svc.service.k_max == k_max
    trows, tickets = _serve(svc, PLAN, order)
    _assert_rows_match_jax(jrows, trows, tickets, seed, jspec, tspec, k_max)


@threaded
def test_async_draws_are_valid_subsets():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=64, deadline_ms=10.0), seed=0,
        device="cpu")
    try:
        rows = svc.sample(8, timeout=WAIT)
        assert len(rows) == 8
        for r in rows:
            assert len(set(r)) == len(r)
            assert all(0 <= i < 4 * 5 for i in r)
    finally:
        svc.close()


def test_model_serving_facade_builds_the_async_tier():
    svc = _model().serving(ServingConfig(max_batch=64, deadline_ms=10.0),
                           tenants={"x": 2}, device="cpu")
    try:
        assert isinstance(svc, AsyncSamplingService)
        assert len(svc.sample(2, tenant="x", timeout=WAIT)) == 2
        assert svc.per_tenant()["x"]["weight"] == 2
    finally:
        svc.close()


def _jax_dense():
    return jdpp.from_kernel(_jax_model().dense_kernel())


@threaded
@pytest.mark.parametrize("family", ["kron", "dense"])
def test_model_serving_matches_jax(family):
    """``model.serving()`` on ``Kron`` and ``Dense``: the JAX facade's
    rows for the same seed and tenants."""
    jm = _jax_model() if family == "kron" else _jax_dense()
    jspec, tspec = _carried(jm)
    tm = (dpp.Kron([np.asarray(f) for f in jm.factors], device="cpu")
          if family == "kron" else
          dpp.from_kernel(np.asarray(jm.factors[0]), device="cpu"))
    k_max = jspec.suggested_k_max()
    config = dict(max_batch=16, deadline_ms=20.0)
    jrows, _ = _serve(jm.serving(JaxConfig(**config), seed=3,
                                 cache=JaxCache()), PLAN, ["a", "a", "b",
                                                           "b", "a"])
    svc = tm.serving(ServingConfig(**config), seed=3, cache=Carried(tspec),
                     device="cpu")
    trows, tickets = _serve(svc, PLAN, ["b", "a", "b", "a", "a"])
    _assert_rows_match_jax(jrows, trows, tickets, 3, jspec, tspec, k_max)


@threaded
def test_lowrank_serving_matches_jax():
    """``LowRank.serving()`` on the carried dual spectrum: the JAX rows,
    up to roundoff ties of the dual chain."""
    jm, jspec, tm, tspec = pair(64, 6, 2, 3.0)
    k_max = jspec.suggested_k_max()
    config = dict(max_batch=16, deadline_ms=20.0)
    jrows, _ = _serve(jm.serving(JaxConfig(**config), seed=5), PLAN,
                      ["a", "b", "a", "b", "a"])
    svc = tm.serving(ServingConfig(**config), seed=5,
                     cache=CarriedDual(tspec), device="cpu")
    trows, tickets = _serve(svc, PLAN, ["a", "a", "a", "b", "b"])
    _assert_rows_match_jax(jrows, trows, tickets, 5, jspec, tspec, k_max,
                           dual=True)


# ---------------------------------------------------------------------------
# the low-rank fleet: per-tenant q over one shared basis
# ---------------------------------------------------------------------------

def _fleet_inputs():
    """``tests/test_lowrank.py``'s fleet: V (64, 8) and two q's from
    seeded keys, as numpy."""
    V = np.array(jax.random.normal(jax.random.PRNGKey(20), (64, 8)))
    qa = np.array(jnp.abs(jax.random.normal(jax.random.PRNGKey(21),
                                            (64,))) + 0.2)
    qb = np.array(jnp.abs(jax.random.normal(jax.random.PRNGKey(22),
                                            (64,))) + 0.2)
    return V, qa, qb


def _fleet(ma, mb, cache, seed=0, **kw):
    return ma.serving(ServingConfig(max_batch=16, deadline_ms=2.0),
                      tenant_models={"a": ma, "b": mb}, seed=seed,
                      cache=cache, **kw)


@threaded
def test_lowrank_fleet_matches_jax_and_costs_two_duals():
    """Two tenants sharing V with their own q: the JAX fleet's rows per
    tenant, the same rows in either submit order, and two r x r dual
    eighs in all across both services."""
    V, qa, qb = _fleet_inputs()
    jma, jmb = (jdpp.LowRank(jnp.asarray(V), jnp.asarray(q))
                for q in (qa, qb))
    jsvc = jma.serving(JaxConfig(max_batch=16, deadline_ms=2.0),
                       tenant_models={"a": jma, "b": jmb}, seed=0,
                       cache=JaxCache())
    jra, jrb = jsvc.sample(3, tenant="a"), jsvc.sample(3, tenant="b")
    jsvc.close()
    Vt = torch.from_numpy(V)                     # one V tensor, shared
    ma = dpp.LowRank(Vt, torch.from_numpy(qa), device="cpu")
    mb = dpp.LowRank(Vt, torch.from_numpy(qb), device="cpu")
    cache = SpectralCache()
    svc = _fleet(ma, mb, cache, device="cpu")
    ra1 = svc.sample(3, tenant="a", timeout=WAIT)
    rb1 = svc.sample(3, tenant="b", timeout=WAIT)
    svc.close()
    svc2 = _fleet(ma, mb, cache, device="cpu")
    rb2 = svc2.sample(3, tenant="b", timeout=WAIT)   # reversed submit order
    ra2 = svc2.sample(3, tenant="a", timeout=WAIT)
    svc2.close()
    assert ra1 == ra2 and rb1 == rb2
    assert ra1 != rb1                      # distinct kernels, distinct draws
    # two tenants sharing V cost two r×r duals total, across BOTH services
    assert cache.stats()["misses"] == 2
    ring = JaxKeyring(0)
    for tenant, jm, tm, want, got in (("a", jma, ma, jra, ra1),
                                      ("b", jmb, mb, jrb, rb1)):
        jspec, tspec = jm.spectrum(JaxCache()), tm.spectrum(cache)
        k_max = jspec.suggested_k_max()
        keys = np.asarray(ring.row_keys([_Ticket(tenant, 0, 3)], 3))
        assert_dual_rows_match(padded(want, k_max), padded(got, k_max), keys,
                               jspec, tspec, k_max)


_Ticket = collections.namedtuple("_Ticket", "tenant seq num_samples")


def test_serving_unknown_tenant_contract():
    V = np.asarray(jax.random.normal(jax.random.PRNGKey(23), (32, 4)))
    m = lowrank_from_numpy(V, np.ones(32, np.float32), device="cpu")
    svc = AsyncSamplingService(
        config=ServingConfig(max_batch=8, deadline_ms=2.0),
        tenant_models={"a": m}, seed=0, device="cpu")
    with pytest.raises(KeyError, match="unknown tenant"):
        svc.submit(1, tenant="nobody")     # no default model configured
    assert len(svc.sample(2, tenant="a", timeout=WAIT)) == 2
    svc.close()
    # with a default model, unnamed tenants fall back to it
    svc2 = m.serving(tenant_models={"a": m}, seed=0, device="cpu")
    assert len(svc2.sample(2, tenant="nobody", timeout=WAIT)) == 2
    svc2.close()
    with pytest.raises(TypeError, match="needs a dpp model"):
        AsyncSamplingService(device="cpu")


@threaded
def test_serving_mixed_tenants_coalesce_in_one_flush():
    V, qa, qb = _fleet_inputs()
    Vt = torch.from_numpy(V)
    ma = dpp.LowRank(Vt, torch.from_numpy(qa), device="cpu")
    mb = dpp.LowRank(Vt, torch.from_numpy(qb), device="cpu")
    svc = ma.serving(ServingConfig(max_batch=4096, deadline_ms=DEADLINE_MS),
                     tenant_models={"a": ma, "b": mb}, seed=0, device="cpu")
    ta = svc.submit(2, tenant="a")
    tb = svc.submit(2, tenant="b")
    assert len(ta.result(timeout=WAIT)) == 2
    assert len(tb.result(timeout=WAIT)) == 2
    svc.close()                            # drains + joins the flush thread
    assert svc.stats.flushes == 1 and svc.stats.deadline_fires == 1
    assert svc.stats.admitted == 2
    # one device call per distinct engine of the flush
    assert [s.stats.device_calls for s in svc._services.values()] == [1, 1]


# ---------------------------------------------------------------------------
# the forms of model.serving() the port once refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(max_batch=8),
                                dict(config=None, max_batch=4)], ids=str)
def test_serving_rejects_max_batch_like_jax(kw):
    """``max_batch`` belongs to ``ServingConfig``: both tiers refuse it as
    a keyword."""
    with pytest.raises(TypeError):
        _jax_model().serving(**kw)
    with pytest.raises(TypeError):
        _model().serving(device="cpu", **kw)


@threaded
@pytest.mark.parametrize("form", ["default", "tenant_models", "dense"])
def test_serving_forms_match_jax(form):
    """``m.serving()``, ``m.serving(tenant_models={"a": m})`` and a
    ``Dense`` model's ``serving()``: the tier the reference builds, with
    its tenants and its rows for one request."""
    jm = _jax_model() if form != "dense" else _jax_dense()
    jspec, tspec = _carried(jm)
    tm = (dpp.Kron([np.asarray(f) for f in jm.factors], device="cpu")
          if form != "dense" else
          dpp.from_kernel(np.asarray(jm.factors[0]), device="cpu"))
    kw = dict(tenant_models={"a": None}) if form == "tenant_models" else {}
    jkw = {k: {"a": jm} for k in kw}
    tkw = {k: {"a": tm} for k in kw}
    jsvc = jm.serving(cache=JaxCache(), **jkw)
    tsvc = tm.serving(cache=Carried(tspec), device="cpu", **tkw)
    tenant = "a" if kw else "default"
    assert type(tsvc).__name__ == type(jsvc).__name__
    assert tsvc.config == ServingConfig() and jsvc.config == JaxConfig()
    want = jsvc.sample(2, tenant=tenant)
    got = tsvc.sample(2, tenant=tenant, timeout=WAIT)
    assert tsvc.per_tenant() == jsvc.per_tenant()
    jsvc.close()
    tsvc.close()
    k_max = jspec.suggested_k_max()
    keys = np.asarray(JaxKeyring(0).row_keys([_Ticket(tenant, 0, 2)], 2))
    assert_dpp_rows_match(padded(want, k_max), padded(got, k_max), keys,
                          jspec, tspec, k_max, form)


# ---------------------------------------------------------------------------
# observability: span parity with the sync path, gauges, health
# ---------------------------------------------------------------------------

def _span_tree(spans, trace_id):
    """{op: parent_op} for one trace — the shape the parity claim pins."""
    mine = [s for s in spans if s["trace"] == trace_id]
    by_id = {s["span"]: s for s in mine}
    return {s["op"]: (by_id[s["parent"]]["op"] if s["parent"] else None)
            for s in mine}


@threaded
def test_async_span_tree_matches_the_sync_path(tmp_path):
    run_log = tmp_path / "run.jsonl"
    jtr = obs.JsonlTracker(str(run_log))
    prev = obs.configure(jtr)
    try:
        sync = _model().service(seed=0, device="cpu")
        sync_ticket = sync.submit(2)
        sync.flush()

        aservice = AsyncSamplingService(
            _model(), ServingConfig(max_batch=4096, deadline_ms=15.0),
            tenants={"a": 1}, seed=0, device="cpu")
        async_ticket = aservice.submit(2, tenant="a")
        async_ticket.result(timeout=WAIT)
        aservice.close()        # joins the flush thread: spans all emitted
    finally:
        obs.configure(prev)
        jtr.close()

    spans = [r["fields"] for r in obs.read_run_log(str(run_log))
             if is_span_record(r)]
    sync_tree = _span_tree(spans, sync_ticket.trace_id)
    async_tree = _span_tree(spans, async_ticket.trace_id)
    service = {"service.request": None, "queue-wait": "service.request",
               "coalesce": "service.request",
               "device-call": "service.request",
               "scatter": "service.request"}
    # the sampler's own spans nest under the device call
    sampler = {"sampling.uniforms": "device-call",
               "sampling.phase1": "device-call"}
    # parity: same ops, same parents, but for the rows' keys: the sync
    # flush splits its key into them (sampling.keys), the async flush
    # takes them from its keyring
    assert sync_tree == dict(service, **sampler,
                             **{"sampling.keys": "device-call"})
    assert async_tree == dict(service, **sampler)
    # the service's async spans are tenant-tagged, every one of them
    assert {s["op"] for s in spans if s["trace"] == async_ticket.trace_id
            and s.get("tenant") == "a"} == set(service)

    # and the run log exports to a well-formed Chrome trace
    out = tmp_path / "trace.json"
    exported = obs.ChromeTraceExporter().export(str(run_log), str(out))
    assert out.exists()
    names = {ev["name"] for ev in exported["traceEvents"]
             if ev.get("ph") == "X"}
    assert {"service.request", "device-call"} <= names


@threaded
def test_serving_metrics_and_health_flow_per_flush():
    svc = AsyncSamplingService(
        _model(), ServingConfig(max_batch=4096, deadline_ms=15.0),
        tenants={"a": 2, "b": 1}, device="cpu")
    try:
        svc.submit(3, tenant="a").result(timeout=WAIT)
        svc.submit(1, tenant="b").result(timeout=WAIT)
        m = svc._metrics
        assert svc.stats.flushes >= 1
        assert svc.stats.admitted == 2
        assert m.counter_value("serving.requested_rows") == 4
        assert 0.0 < m.gauges["serving.batch_occupancy"] <= 1.0
        assert m.percentile("serving.latency_s", 50) > 0.0
        assert svc.stats.p99_latency_s >= svc.stats.p50_latency_s
        assert svc.service.stats.health == "healthy"
        snap = svc.stats()
        assert set(snap) == set(svc.stats.KEYS)
        assert svc.stats["flushes"] == snap["flushes"]
        with pytest.raises(KeyError):
            svc.stats["nope"]
        assert repr(svc.stats).startswith("ServingStats(")
    finally:
        svc.close()


def test_serving_metric_names_match_the_jax_tier():
    """One request through each tier under an in-memory tracker: the same
    ``serving.*`` and ``service.*`` metric names and the same counts."""
    def names(t):
        return {n for n in (*t.counters, *t.gauges, *t.observations)
                if n.startswith(("serving.", "service."))}

    jt, tt = jax_obs.InMemoryTracker(), obs.InMemoryTracker()
    with jax_obs.use(jt):
        svc = JaxAsync(_jax_model(), JaxConfig(max_batch=4,
                                               deadline_ms=LONG_MS))
        svc.submit(4, tenant="a").result(timeout=WAIT)
        svc.close()
    with obs.use(tt):
        svc = AsyncSamplingService(_model(), ServingConfig(
            max_batch=4, deadline_ms=LONG_MS), device="cpu")
        svc.submit(4, tenant="a").result(timeout=WAIT)
        svc.close()
    assert names(tt) == names(jt)
    for n in jt.counters:
        if n.startswith(("serving.", "service.")):
            assert tt.counter_value(n) == jt.counter_value(n), n


# ---------------------------------------------------------------------------
# the sync service's failure paths
# ---------------------------------------------------------------------------

def test_failed_device_call_leaves_tickets_retryable(monkeypatch):
    svc = _model().service(seed=0, device="cpu")
    ticket = svc.submit(2)

    import repro_torch.sampling.service as service_mod
    real = service_mod.sample_krondpp_batched

    def boom(*a, **k):
        raise RuntimeError("device OOM (injected)")

    monkeypatch.setattr(service_mod, "sample_krondpp_batched", boom)
    with pytest.raises(RuntimeError, match="device OOM"):
        ticket.result()                 # result() drives the failing flush
    # the flush died mid-device-call: the ticket must still be pending
    assert ticket in svc._pending
    assert not ticket.done()

    monkeypatch.setattr(service_mod, "sample_krondpp_batched", real)
    rows = ticket.result()              # retry flushes and resolves
    assert len(rows) == 2 and ticket.done()


def test_unresolved_after_flush_error_message_path():
    svc = _model().service(seed=0, device="cpu")
    orphan = SampleTicket(svc, 2)
    with pytest.raises(RuntimeError, match="unresolved after flush"):
        orphan.result()


# ---------------------------------------------------------------------------
# batcher plumbing details
# ---------------------------------------------------------------------------

def test_async_ticket_result_timeout_names_the_tenant():
    class Inert(ContinuousBatcher):
        def _flush(self, batch, trigger):       # pragma: no cover
            raise AssertionError("must not flush")

    b = Inert(ServingConfig(max_batch=4096, deadline_ms=LONG_MS),
              device="cpu")
    try:
        t = b._enqueue(AsyncTicket("slowpoke", 1))
        with pytest.raises(TimeoutError, match="slowpoke"):
            t.result(timeout=0.05)
    finally:
        b.close(drain=False)
    with pytest.raises(ValueError):
        AsyncTicket("t", 0)


@threaded
def test_context_manager_drains_on_clean_exit():
    with AsyncSamplingService(
            _model(), ServingConfig(max_batch=4096, deadline_ms=LONG_MS),
            device="cpu") as svc:
        t = svc.submit(2)
    assert len(t.result(timeout=1.0)) == 2
    assert svc.stats.drain_fires == 1


@threaded
def test_context_manager_cancels_on_an_error():
    with pytest.raises(KeyboardInterrupt):
        with AsyncSamplingService(
                _model(), ServingConfig(max_batch=4096,
                                        deadline_ms=LONG_MS),
                device="cpu") as svc:
            t = svc.submit(2)
            raise KeyboardInterrupt
    with pytest.raises(CancelledRequest):
        t.result(timeout=1.0)


@threaded
def test_flushes_run_on_the_flush_thread_under_the_device():
    """The flush runs on the batcher's own thread; on the CPU it enters
    no CUDA device context (``torch.cuda.device`` is not called)."""
    seen = {}

    class Probe(ContinuousBatcher):
        def _flush(self, batch, trigger):
            seen["thread"] = threading.current_thread().name
            for t in batch:
                t._resolve(trigger)

    b = Probe(ServingConfig(max_batch=1, deadline_ms=LONG_MS),
              device="cpu")
    assert b.device == torch.device("cpu")
    assert b._enqueue(AsyncTicket("t", 1)).result(timeout=WAIT) == "batch"
    b.close()
    assert seen["thread"] == "repro-serving-flush"


def test_service_must_live_on_the_tier_device():
    svc = _model().service(seed=0, device="cpu")
    tier = AsyncSamplingService(service=svc, device="cpu")
    assert tier.service is svc
    tier.close()
    with pytest.raises(ValueError, match="draws on"):
        AsyncSamplingService(service=svc, device="meta")


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_serving_on_the_card_matches_serial_draw_keyed():
    """On a card: a few requests through ``model.serving()`` against a
    serial ``draw_keyed`` of each request's keys (bit for bit), the flush
    thread's phase-2 launches on the spectrum's device, and the rows
    against a CPU copy (identical or roundoff ties)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.kernels import phase2_select as p2
    with jax.default_device(jax.devices("cpu")[0]):
        jm = _jax_model()
        jspec, tspec = _carried(jm)
    k_max = jspec.suggested_k_max()
    model = dpp.Kron([np.asarray(f) for f in jm.factors], device="cuda")
    card = Carried(tspec.to("cuda"))
    p2.launches = 0
    svc = model.serving(ServingConfig(max_batch=8, deadline_ms=50.0),
                        tenants={"a": 2, "b": 1}, seed=4, cache=card,
                        device="cuda")
    rows, tickets = _serve(svc, PLAN, ["a", "b", "a", "b", "a"])
    assert p2.launches == svc.service.stats.device_calls > 0
    assert svc.stats.failed_flushes == 0
    for tenant, reqs in rows.items():
        for t, got in zip(tickets[tenant], reqs):
            keys = svc._keyring.row_keys([t], t.num_samples)
            assert keys.is_cuda
            assert svc.service.draw_keyed(keys)[0] == got
            cpu = Carried(tspec)
            cpu_svc = dpp.Kron([np.asarray(f) for f in jm.factors],
                               device="cpu").service(cache=cpu,
                                                     device="cpu")
            want = cpu_svc.draw_keyed(keys.cpu())[0]
            assert_dpp_rows_match(padded(want, k_max), padded(got, k_max),
                                  tr.key_data(keys), jspec, tspec, k_max,
                                  f"card {tenant} {t.seq}")
