"""Continuous-batching core: background flush thread + futures tickets
(port of ``repro/serving/batcher.py``).

``ContinuousBatcher`` is the async engine both serving front-ends share
(``AsyncSamplingService`` for DPP draws, ``KVCompactionClient`` for k-DPP
KV compaction). It owns:

- the condition variable protecting the tenant queues,
- the flush thread, which fires when pending rows reach ``max_batch``
  ("batch" trigger) OR the oldest queued ticket approaches its
  ``deadline_ms`` completion target ("deadline" trigger — fired early by
  an EWMA of recent flush cost so the ticket *resolves* by the deadline)
  — whichever comes first — and once more at shutdown to drain
  stragglers ("drain" trigger),
- admission control (bounded per-tenant depth → typed ``QueueFull``),
- graceful shutdown: ``close(drain=True)`` flushes everything pending
  before the thread exits; ``close(drain=False)`` fails every queued
  ticket with ``CancelledRequest``.

Subclasses implement ``_flush(batch, trigger)`` — called OFF the lock, on
the background thread, with a list of tickets drained by weighted
round-robin (``queues.drain_weighted``). A ``_flush`` that raises fails
exactly that batch's tickets (each ``result()`` re-raises the error) and
the thread keeps serving.

The deadline-vs-batch trade-off in one sentence: ``deadline_ms`` is the
latency you are willing to spend buying occupancy, ``max_batch`` is the
occupancy at which waiting longer buys nothing.

Tickets are futures (``threading.Event``), safe to resolve from any
thread; the flush thread resolves them, submitter threads block in
``result(timeout=...)``.

Devices: a batcher serves one device (``device=``, default "cuda", which
raises without a card unless "cpu" is passed). The flush thread runs each
flush inside ``torch.cuda.device(device)`` when that device is a card, so
anything a flush asks of "the current device" (a kernel's route query,
say) sees the device its tensors live on, not the thread's default one;
under a ``Mesh`` runtime each shard's draw enters its own device's context
(``Mesh.map_keys``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, List, Optional


from .. import obs
from .._device import DeviceLike, canonical_device, device_context
from .queues import (CancelledRequest, QueueFull, ServiceClosed,
                     _TenantState, drain_weighted, parse_tenants)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for the continuous-batching loop.

    max_batch        flush as soon as this many rows are pending (also the
                     WRR row budget per flush, and the shared
                     ``SamplingService``'s device chunk size).
    deadline_ms      completion target: a queued ticket should RESOLVE at
                     most this long after submission — the latency ceiling
                     a lone request pays to wait for coalescing partners.
                     The loop fires the flush early by an EWMA estimate of
                     recent flush cost so the deadline covers the whole
                     queue-wait + flush, not just the queue-wait.
    max_queue_depth  per-tenant bound; submits past it raise ``QueueFull``.
    default_weight   WRR weight for tenants auto-registered at submit().
    """

    max_batch: int = 64
    deadline_ms: float = 5.0
    max_queue_depth: int = 256
    default_weight: int = 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.default_weight < 1:
            raise ValueError("default_weight must be >= 1")


class AsyncTicket:
    """Future for one async request; resolvable from any thread.

    Mirrors the synchronous ``SampleTicket`` span contract — ``trace_id``
    and the root span id are minted at submit, so the background flush
    thread can parent the request's ``queue-wait → coalesce → device-call
    → scatter`` tree on it via the explicit ``parent=`` hand-off. Unlike
    the sync ticket, ``result()`` blocks on an event instead of driving
    the flush itself.
    """

    def __init__(self, tenant: str, num_samples: int, payload: Any = None):
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.tenant = tenant
        self.num_samples = int(num_samples)
        self.payload = payload
        self.seq: Optional[int] = None      # set at admission, under lock
        self._submitted = time.perf_counter()
        self._submitted_ts = time.time()
        self.trace_id = obs.spans.new_trace_id()
        self._span_id = obs.spans.new_span_id()
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    @property
    def span_tags(self) -> dict:
        """Extra tags stamped on every span of this request's tree."""
        return {"tenant": self.tenant}

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, value: Any) -> None:
        self._result = value
        self._event.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the background flush resolves this ticket.

        Raises ``TimeoutError`` if the flush thread hasn't gotten to it in
        ``timeout`` seconds, or re-raises the flush error / cancellation
        (``CancelledRequest``) if the ticket failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"async ticket (tenant {self.tenant!r}, "
                f"{self.num_samples} rows) unresolved after {timeout}s — "
                f"is the serving tier closed or the flush thread wedged?")
        if self._error is not None:
            raise self._error
        return self._result


class ContinuousBatcher:
    """Tenant queues + deadline/batch-triggered background flushing.

    Subclass contract: implement ``_flush(batch, trigger)``; enqueue via
    ``self._enqueue(AsyncTicket(...))``. The flush thread starts lazily on
    the first admit (so idle construction spawns nothing) and exits when
    ``close()`` drains or cancels the queues. Use as a context manager
    for drain-on-exit. Flushes run under ``torch.cuda.device(device)``
    when ``device`` is a card.
    """

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 tenants=None, tracker=None,
                 thread_name: str = "repro-serving-flush",
                 device: DeviceLike = "cuda"):
        self.device = canonical_device(device)
        self.config = config if config is not None else ServingConfig()
        self._tracker = tracker
        self._metrics = obs.InMemoryTracker()
        self._cond = threading.Condition()
        #: guarded-by: _cond
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
        for name, weight in parse_tenants(tenants).items():
            self._tenants[name] = _TenantState(name, weight)
        self._rows_pending = 0                     #: guarded-by: _cond
        self._closed = False                       #: guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  #: guarded-by: _cond
        self._thread_name = thread_name
        # EWMA of flush wall time (s): the deadline trigger fires this
        # much early so deadline_ms bounds submit->resolve, not
        # submit->flush-start. Conservative prior until measured; only
        # the flush thread reads/writes it.
        self._flush_cost_ewma = 5e-3

    # -- observability ------------------------------------------------------
    def _external_tracker(self):
        """External sink only (explicit ``tracker=`` or the process-wide
        seam) — spans/events target this alone, exactly like
        ``SamplingService._external_tracker``."""
        return self._tracker if self._tracker is not None \
            else obs.current_tracker()

    @property
    def tracker(self):
        """Per-batcher accumulator teed with the external sink; the
        ``serving.*`` metric stream."""
        return obs.tee(self._metrics, self._external_tracker())

    # -- admission ----------------------------------------------------------
    def register_tenant(self, name: str, weight: Optional[int] = None
                        ) -> None:
        """Pre-register a tenant (fixes its WRR cycle position/weight);
        submits to unknown tenants auto-register at ``default_weight``."""
        with self._cond:
            if name in self._tenants:
                self._tenants[name].weight = int(
                    weight if weight is not None
                    else self._tenants[name].weight)
                return
            self._tenants[name] = _TenantState(
                name, weight if weight is not None
                else self.config.default_weight)

    def _enqueue(self, ticket: AsyncTicket) -> AsyncTicket:
        tr = self.tracker
        with self._cond:
            if self._closed:
                tr.counter("serving.rejected", tenant=ticket.tenant,
                           reason="closed")
                raise ServiceClosed(ticket.tenant)
            ts = self._tenants.get(ticket.tenant)
            if ts is None:
                ts = _TenantState(ticket.tenant, self.config.default_weight)
                self._tenants[ticket.tenant] = ts
            if len(ts.queue) >= self.config.max_queue_depth:
                ts.rejected += 1
                tr.counter("serving.rejected", tenant=ticket.tenant,
                           reason="queue_full")
                raise QueueFull(ticket.tenant, len(ts.queue),
                                self.config.max_queue_depth)
            ticket.seq = ts.seq
            ts.seq += 1
            ts.queue.append(ticket)
            ts.admitted += 1
            self._rows_pending += ticket.num_samples
            depth = sum(len(s.queue) for s in self._tenants.values())
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=self._thread_name)
                self._thread.start()
            self._cond.notify_all()
        tr.counter("serving.admitted", tenant=ticket.tenant)
        tr.counter("serving.requested_rows", ticket.num_samples,
                   tenant=ticket.tenant)
        tr.gauge("serving.queue_depth", depth)
        return ticket

    # -- flush loop ---------------------------------------------------------
    def _oldest_locked(self) -> Optional[float]:
        heads = [ts.queue[0]._submitted
                 for ts in self._tenants.values() if ts.queue]
        return min(heads) if heads else None

    def _loop(self) -> None:
        while True:
            with self._cond:
                trigger = None
                while trigger is None:
                    if self._rows_pending >= self.config.max_batch:
                        trigger = "batch"
                    elif self._closed:
                        if self._rows_pending == 0:
                            return
                        trigger = "drain"
                    elif self._rows_pending == 0:
                        self._cond.wait()
                    else:
                        oldest = self._oldest_locked()
                        deadline_s = self.config.deadline_ms / 1e3
                        # fire early by the estimated flush cost (capped
                        # at half the deadline) so the oldest ticket
                        # resolves by its deadline instead of merely
                        # starting to flush then
                        lead = min(self._flush_cost_ewma, deadline_s / 2)
                        left = (deadline_s - lead
                                - (time.perf_counter() - oldest))
                        if left <= 0:
                            trigger = "deadline"
                        else:
                            self._cond.wait(timeout=left)
                batch = drain_weighted(self._tenants, self.config.max_batch)
                self._rows_pending -= sum(t.num_samples for t in batch)
                depth = sum(len(ts.queue) for ts in self._tenants.values())
            if not batch:
                continue
            tr = self.tracker
            tr.counter(f"serving.{trigger}_fires")
            tr.gauge("serving.queue_depth", depth)
            fstart = time.perf_counter()
            try:
                with device_context(self.device):
                    self._flush(batch, trigger)
                tr.counter("serving.flushes")
                cost = time.perf_counter() - fstart
                self._flush_cost_ewma += 0.25 * (cost
                                                 - self._flush_cost_ewma)
            except BaseException as e:   # noqa: BLE001 — fail the batch,
                for t in batch:          # keep the loop serving
                    t._reject(e)
                tr.counter("serving.failed_flushes")

    def _flush(self, batch: List[AsyncTicket], trigger: str) -> None:
        raise NotImplementedError

    # -- shutdown -----------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = 30.0
              ) -> None:
        """Stop admitting; drain (default) or cancel everything queued,
        then join the flush thread. Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            cancelled: List[AsyncTicket] = []
            if not drain:
                for ts in self._tenants.values():
                    cancelled.extend(ts.queue)
                    ts.queue.clear()
                self._rows_pending = 0
            thread = self._thread
            self._cond.notify_all()
        tr = self.tracker
        for t in cancelled:
            t._reject(CancelledRequest(t.tenant))
            tr.counter("serving.cancelled", tenant=t.tenant)
        if thread is not None:
            thread.join(timeout)
        if not already:
            tr.event("serving.closed", drained=drain)

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- introspection ------------------------------------------------------
    def per_tenant(self) -> dict:
        """{tenant: {weight, queued, admitted, rejected}} snapshot."""
        with self._cond:
            return {ts.name: {"weight": ts.weight, "queued": len(ts.queue),
                              "admitted": ts.admitted,
                              "rejected": ts.rejected}
                    for ts in self._tenants.values()}
