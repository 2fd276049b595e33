"""repro_torch.serving — the async continuous-batching serving tier of the
port (port of ``repro/serving``).

The synchronous ``SamplingService`` (``repro_torch.sampling.service``) is
a coalescing engine whose flush the *caller* drives; this package puts a
background thread in charge:

- **continuous batching** — a flush fires when pending rows reach
  ``max_batch`` OR the oldest request ages past ``deadline_ms``,
  whichever comes first;
- **multi-tenant fairness** — per-tenant bounded FIFOs drained by
  weighted round-robin; overflow fast-fails with a typed ``QueueFull``;
- **futures tickets** — ``submit()`` returns immediately; ``result()``
  blocks; resolution is safe from any thread;
- **graceful shutdown** — ``close(drain=True)`` flushes stragglers,
  ``drain=False`` cancels them with ``CancelledRequest``;
- **determinism** — requests are PRNG-keyed by (tenant, sequence
  number), not by flush composition, with the JAX package's keys;
- **observability** — the same per-request ``queue-wait → coalesce →
  device-call → scatter`` span trees as the sync path, tenant-tagged,
  plus ``serving.*`` metrics and a ``HealthMonitor`` verdict per flush.

Every entry point takes ``device=`` (default "cuda"; raises without a
card unless "cpu" is passed), and the flush thread runs inside that
device's context.

Module map
----------
queues.py   tenant state, typed rejections, WRR drain.
batcher.py  ``ServingConfig`` + ``ContinuousBatcher`` (the flush thread)
            + ``AsyncTicket`` futures.
service.py  ``AsyncSamplingService`` — DPP draws; also via
            ``model.serving(...)`` on any ``repro_torch.dpp`` model.
kv.py       ``KVCompactionClient`` — k-DPP KV compaction for concurrent
            decode streams (one selection call per coalesced flush).
keys.py     ``TenantKeyring``: (tenant, sequence number, row)-keyed PRNG
            keys for coalesced flushes, derived a flush at a time.
"""

from .batcher import AsyncTicket, ContinuousBatcher, ServingConfig
from .keys import TenantKeyring
from .kv import KVCompactionClient
from .queues import (CancelledRequest, QueueFull, RejectedRequest,
                     ServiceClosed, parse_tenants)
from .service import AsyncSamplingService, ServingStats

__all__ = [
    "AsyncSamplingService", "AsyncTicket", "ContinuousBatcher",
    "KVCompactionClient", "ServingConfig", "ServingStats",
    "RejectedRequest", "QueueFull", "ServiceClosed", "CancelledRequest",
    "parse_tenants", "TenantKeyring",
]
