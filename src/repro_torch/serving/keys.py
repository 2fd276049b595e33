"""Per-request PRNG keying for the serving tier, batched per flush (port of
``repro/serving/keys.py``).

The determinism contract: row ``j`` of the request with per-tenant
sequence number ``seq`` from tenant ``T`` is always drawn from

    fold_in(fold_in(fold_in(PRNGKey(seed), crc32(T) & 0x7FFFFFFF), seq), j)

— a function of (seed, tenant, seq, j) alone, independent of how the
flush coalesced traffic, and the JAX package's key for the same
(seed, tenant, seq, j). ``TenantKeyring.row_keys`` derives a whole flush's
keys (pad rows included) in one batched pair of ``fold_in`` calls on the
device, not one call per request.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

from .. import random as prng
from .._device import DeviceLike, resolve_device

#: the reserved fold of pad rows; crc32 tags are masked to 31 bits, so a
#: real tenant's tag collides with it with probability 2^-31, and then one
#: discarded pad row repeats a request row's draw
PAD_TAG = 0x7FFFFFFF


def tenant_tag(tenant: str) -> int:
    """The 31-bit tag folded into the base key for ``tenant``."""
    return zlib.crc32(tenant.encode("utf-8")) & 0x7FFFFFFF


class TenantKeyring:
    """Derives (tenant, seq, row)-keyed PRNG keys for coalesced flushes,
    on ``device`` (default "cuda"; raises without a card unless "cpu").

    Tenant keys are cached as host words, so a flush's key assembly is
    numpy work plus one transfer and two ``fold_in`` launches. Only the
    flush thread touches a keyring, so the cache needs no lock."""

    def __init__(self, seed: int, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._base = prng.PRNGKey(seed, self.device)
        self._pad = prng.key_data(
            prng.fold_in(prng.fold_in(self._base, PAD_TAG), PAD_TAG))
        self._tenant_keys: Dict[str, np.ndarray] = {}

    def tenant_key(self, tenant: str) -> np.ndarray:
        """fold_in(base, tag(tenant)) as host uint32 words (2,)."""
        k = self._tenant_keys.get(tenant)
        if k is None:
            k = prng.key_data(prng.fold_in(self._base, tenant_tag(tenant)))
            self._tenant_keys[tenant] = k
        return k

    def row_keys(self, tickets: List, padded: int) -> torch.Tensor:
        """(padded, 2) keys on the keyring's device: every ticket's rows in
        ticket order (a ticket has ``tenant``, ``seq`` and
        ``num_samples``), then pad rows fold_in(fold_in(pad, 0), j). One
        batched derivation whatever the number of tickets."""
        tks = np.empty((padded, 2), np.int64)
        seqs = np.zeros((padded,), np.int64)
        idx = np.empty((padded,), np.int64)
        off = 0
        for t in tickets:
            n = t.num_samples
            tks[off: off + n] = self.tenant_key(t.tenant)
            seqs[off: off + n] = t.seq
            idx[off: off + n] = np.arange(n)
            off += n
        tks[off:] = self._pad
        idx[off:] = np.arange(padded - off)
        host = torch.from_numpy(np.stack([tks[:, 0], tks[:, 1], seqs, idx],
                                         axis=1)).to(self.device)
        return prng.fold_in(prng.fold_in(host[:, :2], host[:, 2]),
                            host[:, 3])
