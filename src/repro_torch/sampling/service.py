"""Micro-batching front-end for the batched sampler (port of
``repro/sampling/service.py``).

Serving and data-pipeline callers each want "a few samples, now"; the card
wants one big batched call. ``SamplingService`` bridges the two:
``submit()`` enqueues a request and returns a ticket, ``flush()`` coalesces
every pending request into one batched call per ``max_batch`` chunk and
scatters the rows back to their tickets. Tickets flush lazily on
``.result()``, so the one-caller path is just ``service.sample(n)``.

Coalesced batch sizes are rounded up to the next power of two (surplus
rows are dropped), capped at ``max_batch``, so a service sees
O(log max_batch) distinct batch shapes.

Determinism: the service owns one PRNG key (``repro_torch.random``),
``PRNGKey(seed)`` on its device, and splits it once per device call
(``key, sub = split(key)``), as the JAX service does: a fixed seed and
submission order reproduce every sample, and give the JAX service's rows
for the same seed and the same sequence of calls.

Thread-safety: one re-entrant lock guards the pending queue, the key and
every flush; any number of threads may ``submit()``/``flush()``/
``result()`` concurrently.

``sample_kdpp`` draws exactly-k subsets immediately (not queued);
``draw_keyed`` draws one subset per explicit row key (the async tier's
batching-invariant entry point).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from .. import obs
from .. import random as prng
from .._device import DeviceLike
from ..core.krondpp import KronDPP
from .batched import (picks_to_lists, sample_krondpp_batched,
                      sample_krondpp_keyed)
from .kdpp import sample_kdpp_batched
from .spectral import SpectralCache, default_cache


class SampleTicket:
    """Handle for a submitted request; ``result()`` flushes if needed.

    Every ticket is a trace root: ``trace_id`` is minted at ``submit()``
    and whichever thread runs ``flush()`` parents its span tree on it, so
    a coalesced flush still attributes queue wait / device time / scatter
    to each individual request (see ``repro_torch.obs.spans``)."""

    def __init__(self, service: "SamplingService", num_samples: int):
        self._service = service
        self.num_samples = num_samples
        self._result: Optional[List[List[int]]] = None
        self._submitted = time.perf_counter()   # queue-wait measurement
        self._submitted_ts = time.time()        # wall anchor for spans
        self.trace_id = obs.spans.new_trace_id()
        self._span_id = obs.spans.new_span_id()  # the request's root span

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> List[List[int]]:
        if self._result is None:
            self._service.flush()
        if self._result is None:
            raise RuntimeError(
                "ticket unresolved after flush — a prior device call "
                "failed; resubmit or flush again")
        return self._result


class ServiceStats:
    """Per-service counters, as a live VIEW over the service's tracker.

    Every count is accumulated by emitting ``service.<key>`` counters
    through the service's per-instance ``obs.InMemoryTracker`` (teed with
    the process-wide ``obs.current_tracker()``), so the numbers here and
    the numbers in a configured run log are the same stream by
    construction. Read them as attributes (``stats.truncations``), by key
    (``stats["flushes"]``, ``KeyError`` on an unknown key), or as one
    plain dict (``stats()``, the key style of ``cache.stats()``).
    Equality compares counter snapshots, against another view or a dict.

    ``ServiceStats(flushes=1)`` builds a detached snapshot over a tracker
    of its own (``TypeError`` on an unknown field, or on counts given
    beside a tracker); its ``health`` reads ``"healthy"``.

    ``truncations`` counts draws whose |J| overflowed the static k_max
    budget and were clipped to the lowest eigen-indices — a many-sigma
    event per draw at the default E|Y| + 6σ budget, so a rising counter
    means k_max is undersized for this kernel.
    """

    KEYS = ("device_calls", "samples_drawn", "samples_requested",
            "flushes", "truncations")

    def __init__(self, metrics: Optional[obs.InMemoryTracker] = None,
                 health: Optional[obs.HealthMonitor] = None, **counts):
        if metrics is None:             # detached snapshot
            metrics = obs.InMemoryTracker()
            for k, v in counts.items():
                if k not in self.KEYS:
                    raise TypeError(f"unknown ServiceStats field {k!r}")
                metrics.counter(f"service.{k}", v)
        elif counts:
            raise TypeError("pass either a metrics tracker or counts, "
                            "not both")
        self._metrics = metrics
        self._health = health

    @property
    def health(self) -> str:
        """The service's ``HealthMonitor`` verdict; a detached snapshot
        has no monitor and reads ``"healthy"``. Not part of the
        ``stats()`` dict — the counter snapshot keys are a pinned
        contract."""
        return self._health.verdict if self._health is not None \
            else "healthy"

    def _value(self, key: str) -> int:
        return int(self._metrics.counter_value(f"service.{key}"))

    def __call__(self) -> dict:
        """Plain-dict snapshot — the same shape as ``cache.stats()``."""
        return {k: self._value(k) for k in self.KEYS}

    def __getitem__(self, key: str) -> int:
        if key not in self.KEYS:
            raise KeyError(key)
        return self._value(key)

    def keys(self):
        return self.KEYS

    def __eq__(self, other) -> bool:
        if isinstance(other, ServiceStats):
            return self() == other()
        if isinstance(other, dict):
            return self() == other
        return NotImplemented

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self().items())
        return f"ServiceStats({body})"


for _key in ServiceStats.KEYS:
    setattr(ServiceStats, _key,
            property(lambda self, k=_key: self._value(k)))
del _key


class SamplingService:
    """Batched exact sampling against one DPP kernel.

    Accepts a ``repro_torch.dpp`` facade model (``Dense`` / ``Kron`` —
    anything with a ``spectrum(cache)`` method) or a ``core.KronDPP``.
    The factor spectra come from a ``SpectralCache`` (shared across
    services by default). ``device`` is where the draws run; the spectrum
    is moved there once.

    ``runtime`` (``repro_torch.dpp.runtime``) picks the placement:
    ``Local()`` / None runs each flush as one batched call; a ``Mesh``
    cuts every flush's keys into one shard a data-axis position (the
    service's key, its results and ``device`` are on the mesh's first
    data shard's device), with identical draws and identical
    ``ServiceStats`` (truncations are counted over ALL shards, pad rows
    never). ``Host()`` has no service (``ValueError``).

    Observability: every flush emits ``service.*`` metrics — the
    ``ServiceStats`` counters plus ``service.queue_wait_s``,
    ``service.flush_s`` / ``service.device_call_s`` timer samples,
    ``service.batch_occupancy`` and ``service.truncation_rate`` — through
    a per-service ``InMemoryTracker`` teed with the process-wide
    ``obs.current_tracker()`` (or an explicit ``tracker=``). With a live
    external tracker each flush also emits a span tree per ticket (root
    ``service.request`` with ``queue-wait → coalesce → device-call →
    scatter`` children) and ``health.*`` sampling sentinels.
    """

    def __init__(self, dpp, k_max: Optional[int] = None,
                 cache: Optional[SpectralCache] = None, seed: int = 0,
                 max_batch: int = 1024, runtime=None, tracker=None,
                 device: DeviceLike = "cuda"):
        from ..dpp import runtime as runtime_mod
        self.cache = cache if cache is not None else default_cache()
        rt = runtime_mod.resolve(runtime)
        if rt.kind == "host":
            raise ValueError("SamplingService is the batched device "
                             "front-end; the host oracle has no service — "
                             "use model.sample(runtime=Host()) directly")
        self.runtime = rt
        if isinstance(dpp, KronDPP):
            spectrum = self.cache.spectrum(dpp)
        elif hasattr(dpp, "spectrum"):          # facade DPPModel
            spectrum = dpp.spectrum(self.cache)
        else:
            raise TypeError(
                f"SamplingService wants a repro_torch.dpp model or "
                f"core.KronDPP, got {type(dpp).__name__}")
        if rt.is_mesh:                          # pinned on every shard
            device = rt.home(device)
            spectrum = rt.pin_spectrum(spectrum)
        self.spectrum = spectrum.to(device)
        self.k_max = int(k_max) if k_max is not None \
            else self.spectrum.suggested_k_max()
        self.max_batch = int(max_batch)
        #: guarded-by: _lock
        self._key = prng.PRNGKey(seed, self.spectrum.device)
        self._pending: List[SampleTicket] = []    #: guarded-by: _lock
        # guards _pending, _key, and flush/draw critical sections; RLock
        # so result() -> flush() composes with callers already holding it
        self._lock = threading.RLock()
        self._metrics = obs.InMemoryTracker()
        self._tracker = tracker
        self.health = obs.HealthMonitor(tracker=lambda: self.tracker,
                                        component="sampling")
        self.stats = ServiceStats(self._metrics, self.health)

    def _external_tracker(self):
        """The external sink only (explicit ``tracker=`` or the
        process-wide seam) — spans and events go here alone."""
        return self._tracker if self._tracker is not None \
            else obs.current_tracker()

    @property
    def tracker(self):
        """The per-service accumulator behind ``stats``, teed with the
        external sink (re-read per call, so ``obs.configure`` after
        construction takes effect)."""
        return obs.tee(self._metrics, self._external_tracker())

    # -- request path -------------------------------------------------------
    def submit(self, num_samples: int) -> SampleTicket:
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        t = SampleTicket(self, num_samples)
        with self._lock:
            self._pending.append(t)
        self.tracker.counter("service.samples_requested", num_samples)
        return t

    def sample(self, num_samples: int) -> List[List[int]]:
        """submit + flush: ``num_samples`` subsets as index lists."""
        return self.submit(num_samples).result()

    def sample_kdpp(self, k: int, num_samples: int = 1) -> List[List[int]]:
        """Exactly-k subsets (conditional ESP draw); immediate, not queued.
        Device calls are chunked at max_batch like ``flush``, each drawn
        from a split of the service key under the lock."""
        drawn: List[List[int]] = []
        remaining = self._round_up(num_samples)
        tr = self.tracker
        with self._lock:
            while len(drawn) < num_samples:
                batch = min(remaining, self.max_batch)
                self._key, sub = prng.split(self._key)
                with tr.timer("service.device_call_s", kind="kdpp"):
                    picks = sample_kdpp_batched(sub, self.spectrum, int(k),
                                                batch, runtime=self.runtime)
                    rows = picks_to_lists(picks)   # synchronizes the card
                tr.counter("service.device_calls")
                tr.counter("service.samples_drawn", batch)
                drawn.extend(rows)
                remaining -= batch
        return drawn[:num_samples]

    def draw_keyed(self, row_keys):
        """Draw one subset per explicit PRNG key (row_keys (n, 2): twin
        keys or the JAX package's uint32 keys), chunked at max_batch.

        Unlike ``flush()``, which splits the service key once per device
        call (draws depend on coalescing), every row here is a function of
        its own key alone — the determinism contract of the async serving
        tier under a background flush of any timing. Updates the shared
        ``service.*`` counters (device_calls, samples_drawn, truncations,
        device_call_s, truncation_rate) so ``stats`` counts sync and keyed
        traffic in one place.

        Returns ``(rows, truncations, collapsed)``: one index list per key,
        in key order, and the counts of this call only. Thread-safe; does
        not touch the pending queue or the service key."""
        row_keys = prng.as_key(row_keys, self.spectrum.device)
        n = int(row_keys.shape[0])
        tr = self.tracker
        rows: List[List[int]] = []
        truncations = 0
        collapsed = 0
        with self._lock:
            for off in range(0, n, self.max_batch):
                chunk = row_keys[off: off + self.max_batch]
                with tr.timer("service.device_call_s", kind="dpp"):
                    picks, counts, truncated = sample_krondpp_keyed(
                        chunk, self.spectrum, self.k_max,
                        runtime=self.runtime)
                    part = picks_to_lists(picks)   # synchronizes the card
                tr.counter("service.device_calls")
                tr.counter("service.samples_drawn", int(chunk.shape[0]))
                n_trunc = int(truncated.sum())
                tr.counter("service.truncations", n_trunc)
                truncations += n_trunc
                want = counts.cpu().tolist()
                collapsed += sum(1 for r, w in zip(part, want)
                                 if len(r) < int(w))
                rows.extend(part)
            m = self._metrics
            tr.gauge("service.truncation_rate",
                     m.counter_value("service.truncations")
                     / max(1, m.counter_value("service.samples_drawn")))
        return rows, truncations, collapsed

    # -- batching core ------------------------------------------------------
    def _round_up(self, n: int) -> int:
        """Batch shapes are powers of two capped at max_batch, plus
        multiples of max_batch — O(log max_batch) distinct shapes."""
        if n >= self.max_batch:
            return ((n + self.max_batch - 1)
                    // self.max_batch) * self.max_batch
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def flush(self) -> None:
        """One batched call per ``max_batch`` chunk for everything
        pending, then scatter. Tickets stay pending until every draw
        succeeds, so a failed call leaves them retryable. The whole flush
        runs under the service lock."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        tickets = list(self._pending)
        tr = self.tracker
        ext = self._external_tracker()
        span_ext = ext if obs.enabled(ext) else None
        t_flush0 = time.perf_counter()
        w_flush0 = time.time()          # wall anchor for span timestamps
        total = sum(t.num_samples for t in tickets)
        drawn: List[List[int]] = []
        remaining = self._round_up(total)
        padded = remaining
        t_coalesced = time.perf_counter()
        batched = 0
        truncations = 0
        collapsed = 0
        carrier = tickets[0]
        live = obs.spans.NULL_SPAN if span_ext is None else \
            obs.spans.start_span("device-call", tracker=span_ext,
                                 parent=(carrier.trace_id, carrier._span_id),
                                 kind="dpp", batch=padded)
        with live:
            while len(drawn) < total:
                batch = min(remaining, self.max_batch)
                self._key, sub = prng.split(self._key)
                with tr.timer("service.device_call_s", kind="dpp"):
                    picks, counts, truncated = sample_krondpp_batched(
                        sub, self.spectrum, self.k_max, batch,
                        runtime=self.runtime)
                    rows = picks_to_lists(picks)   # synchronizes the card
                tr.counter("service.device_calls")
                tr.counter("service.samples_drawn", batch)
                batched += batch
                # under a mesh `truncated` is the GLOBAL (all-shard) row
                # vector with the shards' pad rows already sliced off, so
                # this sum counts every shard's clipped draws once
                n_trunc = int(truncated.sum())
                tr.counter("service.truncations", n_trunc)
                truncations += n_trunc
                # residual-mass collapse sentinel: rows whose phase 2 ran
                # out of probability mass before drawing |J| items
                want = counts.cpu().tolist()
                collapsed += sum(1 for r, w in zip(rows, want)
                                 if len(r) < int(w))
                drawn.extend(rows)
                remaining -= batch
        t_device_done = time.perf_counter()
        del self._pending[: len(tickets)]
        tr.counter("service.flushes")
        now = time.perf_counter()
        tr.observe("service.flush_s", now - t_flush0, tickets=len(tickets))
        tr.gauge("service.batch_occupancy", total / max(1, batched))
        m = self._metrics
        tr.gauge("service.truncation_rate",
                 m.counter_value("service.truncations")
                 / max(1, m.counter_value("service.samples_drawn")))
        off = 0
        for t in tickets:
            tr.observe("service.queue_wait_s", now - t._submitted)
            t._result = drawn[off: off + t.num_samples]
            off += t.num_samples
        self.health.check_sampling(drawn=batched, truncated=truncations,
                                   collapsed=collapsed)
        if span_ext is not None:
            self.health.report(emit=True, tracker=span_ext)
            emit_flush_spans(span_ext, tickets, carrier, w_flush0, t_flush0,
                             t_coalesced, t_device_done, time.perf_counter())


def emit_flush_spans(ext, tickets, carrier, w0, t0, t1, t2, t3,
                     kind: str = "dpp") -> None:
    """Synthesize each ticket's span tree after a coalesced flush.

    The flush phases were timed once on the monotonic clock (t0 start →
    t1 coalesced → t2 device done → t3 scattered) and are replicated into
    every ticket's trace, mapped onto the wall clock via the flush anchor
    (w0 ↔ t0). The carrier's device-call span must already have been
    emitted live by the flusher, parented on
    ``(carrier.trace_id, carrier._span_id)`` — the documented thread-hop
    mechanism — so this helper works identically from the submitting
    thread (sync ``flush()``) and from a background flush thread.

    Tickets may expose ``span_tags`` (a dict); the async tier uses it to
    stamp ``tenant=`` on every span of a request's tree.
    """
    def wall(t):
        return w0 + (t - t0)

    for t in tickets:
        tags = dict(getattr(t, "span_tags", None) or {})
        kw = dict(trace_id=t.trace_id, parent_id=t._span_id, **tags)
        obs.spans.emit_span(ext, "queue-wait", ts=t._submitted_ts,
                            dur_s=max(t0 - t._submitted, 0.0), **kw)
        obs.spans.emit_span(ext, "coalesce", ts=wall(t0), dur_s=t1 - t0,
                            tickets=len(tickets), **kw)
        if t is not carrier:
            obs.spans.emit_span(ext, "device-call", ts=wall(t1),
                                dur_s=t2 - t1, kind=kind, **kw)
        obs.spans.emit_span(ext, "scatter", ts=wall(t2), dur_s=t3 - t2,
                            **kw)
        obs.spans.emit_span(ext, "service.request", trace_id=t.trace_id,
                            span_id=t._span_id, parent_id=None,
                            ts=t._submitted_ts,
                            dur_s=max(wall(t3) - t._submitted_ts, 0.0),
                            num_samples=t.num_samples, **tags)
