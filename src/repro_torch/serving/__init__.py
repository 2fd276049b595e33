"""repro_torch.serving — the serving tier of the port (port of
``repro/serving``).

keys.py  ``TenantKeyring``: (tenant, sequence number, row)-keyed PRNG keys
         for coalesced flushes, derived a flush at a time.

Not ported yet (ROADMAP.md, queue 1: serving/ and the obs exporters):
``AsyncSamplingService``, the queues and the continuous batcher, and the
KV-compaction service; ``model.serving()`` raises until they are.
"""

from .keys import TenantKeyring

__all__ = ["TenantKeyring"]
