"""Tenant queues, admission control, and weighted round-robin draining
(a copy of ``repro/serving/queues.py``, which is stdlib-only; the port
keeps its own so that it imports nothing of the JAX package).

The serving tier multiplexes many tenants onto one device. Fairness and
overload behavior live here, as plain data structures the batcher drives
under its own condition-variable lock:

- each tenant owns a bounded FIFO (``_TenantState``); overflow fast-fails
  at ``submit()`` with a typed ``QueueFull`` instead of buffering into
  unbounded latency,
- ``drain_weighted`` assembles a flush batch by cycling tenants in
  registration order, taking up to ``weight`` requests per tenant per
  cycle — a heavy tenant gets proportionally more slots per flush but can
  never starve a light one, because every nonempty queue is visited every
  cycle,
- requests are never split across flushes: a request's rows always land
  in one device call, so the batch may overshoot the row budget by at
  most one request.

Everything here is lock-free by design — callers (``ContinuousBatcher``)
hold the batcher lock around every touch.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Union


class RejectedRequest(RuntimeError):
    """Base of the typed fast-fail rejections raised at ``submit()``.

    Carries structured fields (``reason``, ``tenant``, plus per-subclass
    detail) so callers can branch on overload vs shutdown without parsing
    the message."""

    reason = "rejected"

    def __init__(self, msg: str, tenant: str):
        super().__init__(msg)
        self.tenant = tenant


class QueueFull(RejectedRequest):
    """Admission control: the tenant's queue is at ``max_queue_depth``."""

    reason = "queue_full"

    def __init__(self, tenant: str, depth: int, limit: int):
        super().__init__(
            f"tenant {tenant!r} queue full ({depth}/{limit}); shed load or "
            f"raise ServingConfig.max_queue_depth", tenant)
        self.depth = depth
        self.limit = limit


class ServiceClosed(RejectedRequest):
    """The service is shutting down (or shut down); no new admissions."""

    reason = "closed"

    def __init__(self, tenant: str):
        super().__init__(
            f"serving tier is closed; rejecting submit from tenant "
            f"{tenant!r}", tenant)


class CancelledRequest(RejectedRequest):
    """The request was queued but ``close(drain=False)`` cancelled it."""

    reason = "cancelled"

    def __init__(self, tenant: str):
        super().__init__(
            f"request from tenant {tenant!r} cancelled by close(drain=False)",
            tenant)


class _TenantState:
    """One tenant's queue + per-tenant counters. Touched only under the
    batcher lock."""

    __slots__ = ("name", "weight", "queue", "seq", "admitted", "rejected")

    def __init__(self, name: str, weight: int):
        if weight < 1:
            raise ValueError(f"tenant {name!r} weight must be >= 1, "
                             f"got {weight}")
        self.name = name
        self.weight = int(weight)
        self.queue: collections.deque = collections.deque()
        self.seq = 0          # per-tenant submission sequence (PRNG keying)
        self.admitted = 0
        self.rejected = 0


def parse_tenants(spec: Union[None, int, str, Dict[str, int], Iterable[str]]
                  ) -> "collections.OrderedDict[str, int]":
    """Normalize a tenant spec into an ordered {name: weight} map.

    Accepts ``None`` (empty; tenants auto-register on first submit at the
    default weight), an int N (``t0..t{N-1}`` at weight 1), a CLI string
    ``"interactive:4,batch:1"`` (``name[:weight]`` comma-separated), a
    {name: weight} dict, or an iterable of names. Registration order is
    the WRR cycle order, so it is part of the fairness contract.
    """
    out: "collections.OrderedDict[str, int]" = collections.OrderedDict()
    if spec is None:
        return out
    if isinstance(spec, int):
        for i in range(spec):
            out[f"t{i}"] = 1
    elif isinstance(spec, str):
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition(":")
            out[name.strip()] = int(w) if w else 1
    elif isinstance(spec, dict):
        for name, w in spec.items():
            out[str(name)] = int(w)
    else:
        for name in spec:
            out[str(name)] = 1
    for name, w in out.items():
        if w < 1:
            raise ValueError(f"tenant {name!r}: weight must be >= 1, "
                             f"got {w}")
    return out


def drain_weighted(tenants: "collections.OrderedDict[str, _TenantState]",
                   budget_rows: int) -> List:
    """Drain up to ``budget_rows`` rows of requests, weighted round-robin.

    Cycles tenants in registration order; each cycle takes up to
    ``weight`` whole requests from each nonempty queue. Stops once the
    drained requests cover the row budget (the last request may overshoot
    — requests are never split) or every queue is empty. Returns the
    drained tickets in drain order.
    """
    batch: List = []
    rows = 0
    while rows < budget_rows:
        progressed = False
        for ts in tenants.values():
            for _ in range(ts.weight):
                if not ts.queue or rows >= budget_rows:
                    break
                t = ts.queue.popleft()
                batch.append(t)
                rows += t.num_samples
                progressed = True
        if not progressed:
            break
    return batch
