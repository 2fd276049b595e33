"""Async continuous-batching front-end for DPP sampling (port of
``repro/serving/service.py``).

``AsyncSamplingService`` is the serving tier over a (now thread-safe)
``SamplingService``: callers on any thread ``submit(n, tenant=...)`` and
get a futures ticket; the background flush thread coalesces whatever is
queued — across tenants, weighted round-robin — into one padded device
call when the batch fills or the deadline expires.

Determinism under async batching
--------------------------------
The synchronous service splits its PRNG key once per device call, so its
draws depend on how requests coalesced — acceptable when the caller
controls flush timing, unacceptable when a background thread does. Here
row ``j`` of a request is keyed by ``(base_seed, tenant, tenant_seq, j)``
(see ``keys.TenantKeyring``) and drawn through the batching-invariant
``SamplingService.draw_keyed`` path, so a fixed seed and fixed per-tenant
submission order reproduces every sample bit-for-bit no matter how the
flush thread sliced the traffic (deadline fires, batch fires, thread
scheduling — all irrelevant to the values drawn). The keys are the JAX
package's for the same (seed, tenant, seq, j), so the rows are its rows.
Bit for bit this holds wherever a row's draw is a function of its key
alone: the Kronecker and dense paths (phase 2 runs one block a row). The
low-rank dual chain runs cuBLAS products whose rounding may change with
the batch, so there a row may move to a neighbouring item on a roundoff
tie at a CDF boundary.

Observability
-------------
Each flush emits the same per-ticket span trees as the sync path (root
``service.request``, children ``queue-wait → coalesce → device-call →
scatter``; carrier's device-call live, via the explicit ``parent=``
thread-hop), tenant-tagged; ``serving.*`` metrics (admit/reject per
tenant, deadline vs batch fires, queue depth, occupancy, latency
percentiles); and a ``HealthMonitor`` verdict per flush through the
shared service's sentinels.

Devices: the tier, its engines and its keyring live on ``device``
(default "cuda"; raises without a card unless "cpu" is passed), and the
flush thread runs its draws inside that device's context. ``runtime=``
placement (``Mesh``/``Host``) is not ported: any value but None raises
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from .. import obs
from .._device import DeviceLike
from ..sampling.service import SamplingService, emit_flush_spans
from .batcher import (AsyncTicket, ContinuousBatcher, ServingConfig,
                      serving_device)
from .keys import TenantKeyring


class ServingStats:
    """Live view over the batcher's ``serving.*`` counters, in the
    ``ServiceStats`` style: attribute access, a ``stats()`` call returning
    a plain dict, and latency percentile helpers."""

    KEYS = ("flushes", "failed_flushes", "batch_fires", "deadline_fires",
            "drain_fires", "admitted", "rejected", "cancelled")

    def __init__(self, metrics: obs.InMemoryTracker):
        self._metrics = metrics

    def _value(self, key: str) -> int:
        return int(self._metrics.counter_value(f"serving.{key}"))

    def __call__(self) -> dict:
        return {k: self._value(k) for k in self.KEYS}

    def __getitem__(self, key: str) -> int:
        if key not in self.KEYS:
            raise KeyError(key)
        return self._value(key)

    def keys(self):
        return self.KEYS

    def latency_percentile(self, p: float) -> float:
        """p-th percentile of end-to-end request latency (seconds),
        submit → resolve, over every resolved ticket."""
        return self._metrics.percentile("serving.latency_s", p)

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99_latency_s(self) -> float:
        return self.latency_percentile(99)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self().items())
        return f"ServingStats({body})"


for _key in ServingStats.KEYS:
    setattr(ServingStats, _key,
            property(lambda self, k=_key: self._value(k)))
del _key


class AsyncSamplingService(ContinuousBatcher):
    """Async multi-tenant serving tier over one DPP kernel.

    ``dpp`` is anything ``SamplingService`` accepts (a ``repro_torch.dpp``
    facade model or ``core.KronDPP``); pass ``service=`` instead to share
    an existing (thread-safe) synchronous service on ``device`` — sync and
    async traffic then aggregate in one ``service.stats``.

    ``tenant_models=`` maps tenant names to their own models (typically
    ``dpp.LowRank`` sharing one basis V with per-tenant quality scores
    q): each named tenant samples from its own kernel through its own
    engine, all engines sharing one SpectralCache — so per-tenant q
    costs one r×r dual eigh per tenant, never an N×N factorization. A
    flush groups tickets by engine and issues one device call per
    distinct kernel; tenants without an entry fall back to ``dpp=`` /
    ``service=`` (if neither exists, ``submit`` raises ``KeyError``).

    Usage::

        svc = model.serving(ServingConfig(max_batch=64, deadline_ms=5.0),
                            tenants={"interactive": 4, "batch": 1})
        ticket = svc.submit(3, tenant="interactive")
        rows = ticket.result(timeout=1.0)   # 3 subsets, index lists
        svc.close()                          # drains, then joins
    """

    def __init__(self, dpp=None, config: Optional[ServingConfig] = None, *,
                 service: Optional[SamplingService] = None, tenants=None,
                 tenant_models=None, seed: int = 0,
                 k_max: Optional[int] = None, cache=None,
                 runtime=None, tracker=None, device: DeviceLike = "cuda"):
        if runtime is not None:
            raise NotImplementedError(
                "AsyncSamplingService(runtime=...) is not ported to "
                "repro_torch yet (ROADMAP.md, queue 1: #7 placement); the "
                "port serves on one device")
        dev = serving_device(device)
        if service is not None and service.spectrum.device != dev:
            raise ValueError(f"service= draws on {service.spectrum.device}, "
                             f"not on device={str(dev)!r}")
        super().__init__(config, tenants=tenants, tracker=tracker,
                         device=dev)
        self.service = None
        if service is not None:
            self.service = service
        elif dpp is not None:
            self.service = SamplingService(
                dpp, k_max=k_max, cache=cache, seed=seed,
                max_batch=self.config.max_batch, tracker=tracker,
                device=dev)
        # per-tenant kernels (the low-rank "shared basis V, per-tenant
        # quality q" pattern): each tenant gets its own engine over its
        # model, all sharing one SpectralCache / runtime / tracker, so a
        # shared-V LowRank fleet costs one r×r dual eigh per tenant and
        # zero N×N work. Immutable after construction — the flush thread
        # only ever reads it, so no lock is needed.
        self._services = {}
        for name, model in (tenant_models or {}).items():
            self._services[name] = SamplingService(
                model, k_max=k_max, cache=cache, seed=seed,
                max_batch=self.config.max_batch, tracker=tracker,
                device=dev)
            self.register_tenant(name)
        if self.service is None and not self._services:
            raise TypeError("AsyncSamplingService needs a dpp model, an "
                            "existing service=, or tenant_models=")
        self._keyring = TenantKeyring(seed, device=dev)
        self.stats = ServingStats(self._metrics)

    def _service_for(self, tenant: str) -> SamplingService:
        svc = self._services.get(tenant, self.service)
        if svc is None:
            raise KeyError(
                f"unknown tenant {tenant!r}: not in tenant_models and no "
                f"default model/service was configured")
        return svc

    # -- request path -------------------------------------------------------
    def submit(self, num_samples: int, tenant: str = "default"
               ) -> AsyncTicket:
        """Enqueue; returns a futures ticket. Raises ``QueueFull`` /
        ``ServiceClosed`` (typed, structured) instead of queuing into
        unbounded latency, and ``KeyError`` synchronously for a tenant
        with neither a per-tenant model nor a default service."""
        self._service_for(tenant)      # unknown-tenant check, fail fast
        return self._enqueue(AsyncTicket(tenant, num_samples))

    def sample(self, num_samples: int, tenant: str = "default",
               timeout: Optional[float] = 60.0) -> List[List[int]]:
        """submit + block: ``num_samples`` subsets as index lists."""
        return self.submit(num_samples, tenant).result(timeout)

    # -- background flush ---------------------------------------------------
    def _flush(self, batch: List[AsyncTicket], trigger: str) -> None:
        # one device call per distinct engine: tickets group by their
        # tenant's service (insertion-ordered, so the default-model group
        # keeps the old single-group behavior byte-for-byte). Draws stay
        # batching-invariant regardless of grouping — every row is keyed
        # by (tenant, seq, row), never by its position in a flush.
        tr = self.tracker
        flush_t0 = time.perf_counter()
        groups: List[Tuple[SamplingService, List[AsyncTicket]]] = []
        by_id = {}
        for t in batch:
            svc = self._service_for(t.tenant)
            g = by_id.get(id(svc))
            if g is None:
                g = (svc, [])
                by_id[id(svc)] = g
                groups.append(g)
            g[1].append(t)
        for svc, tickets in groups:
            self._flush_group(svc, tickets, trigger)
        tr.gauge("serving.requests_per_flush", len(batch))
        tr.observe("serving.flush_s", time.perf_counter() - flush_t0,
                   trigger=trigger, tickets=len(batch))

    def _flush_group(self, svc: SamplingService,
                     tickets: List[AsyncTicket], trigger: str) -> None:
        tr = self.tracker
        ext = self._external_tracker()
        span_ext = ext if obs.enabled(ext) else None
        t0 = time.perf_counter()
        w0 = time.time()
        total = sum(t.num_samples for t in tickets)
        padded = svc._round_up(total)
        row_keys = self._keyring.row_keys(tickets, padded)
        t1 = time.perf_counter()
        carrier = tickets[0]
        live = obs.spans.NULL_SPAN if span_ext is None else \
            obs.spans.start_span("device-call", tracker=span_ext,
                                 parent=(carrier.trace_id, carrier._span_id),
                                 kind="dpp", batch=padded, trigger=trigger,
                                 tenant=carrier.tenant)
        with live:
            rows, truncations, collapsed = svc.draw_keyed(row_keys)
        t2 = time.perf_counter()
        off = 0
        for t in tickets:
            t._resolve(rows[off: off + t.num_samples])
            off += t.num_samples
        t3 = time.perf_counter()
        for t in tickets:
            tr.observe("serving.latency_s", t3 - t._submitted,
                       tenant=t.tenant)
            tr.observe("serving.queue_wait_s", t0 - t._submitted,
                       tenant=t.tenant)
        # requested rows per padded row (utilization, <= 1); requests
        # per device call (the "occupancy > 1" coalescing claim) is a
        # whole-flush gauge emitted by _flush
        tr.gauge("serving.batch_occupancy", total / max(1, padded))
        svc.health.check_sampling(drawn=padded, truncated=truncations,
                                  collapsed=collapsed)
        if span_ext is not None:
            svc.health.report(emit=True, tracker=span_ext)
            emit_flush_spans(span_ext, tickets, carrier, w0, t0, t1, t2, t3)
