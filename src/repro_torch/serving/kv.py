"""Coalescing client for k-DPP KV-cache compaction under traffic (port of
``repro/serving/kv.py``).

Concurrent decode streams each want "compact my cache's heads, now"; each
head's selection is an independent k-DPP draw over that head's key
vectors. ``KVCompactionClient`` batches them: streams submit their heads
as ``(H, S, d)`` stacks, the background flush thread groups whatever is
pending by shape ``(S, d)`` and runs one selection call per group
(``_select_heads``) — so two decode streams compacting at the same moment
share one flush, not two.

The JAX client runs a group as one jitted ``vmap`` over heads. Here the
call runs ``dpp_select_tokens(method="sample")`` once per head, in order:
each head's kernel gets an ``eigh`` of its own, then the ESP phase 1 and
one ``phase2_select`` launch (m = 1, N = S). A batched ``eigh`` is not
promised to round each matrix as it would alone, and a head's picks must
not depend on which heads shared its flush.

PRNG keying matches ``AsyncSamplingService``: head j of a request is keyed
``fold_in(fold_in(fold_in(base, crc32(tenant)), tenant_seq), j)``
(``keys.TenantKeyring``), the JAX client's key for the same head, so picks
are reproducible regardless of which streams happened to coalesce. The
JAX client pads a group to a power of two of heads to bound its compiled
shapes; the port compiles nothing and draws no pad head. A real head's key
is the same either way: ``row_keys(tickets, padded)`` starts with the
real heads' rows whatever ``padded`` is. So ``serving.batch_occupancy``
(heads requested per head drawn) is 1.0 here, where the JAX client
reports requested over padded heads.

Tickets resolve to the sorted kept positions, an ``(H, budget)`` int32
tensor on the client's device — the caller owns the gather.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike
from ..sampling.service import emit_flush_spans
from ..serve.kv_compaction import dpp_select_tokens
from .batcher import AsyncTicket, ContinuousBatcher, ServingConfig
from .keys import TenantKeyring


def _select_heads(heads: Sequence, valid: Sequence[int],
                  rkeys: torch.Tensor, budget: int,
                  recency: int) -> torch.Tensor:
    """One selection call: an exact k-DPP token selection per head, each a
    function of its keys (S, d), its valid length and its row key alone.
    -> picks (H, budget) int32 (sorted kept positions per head)."""
    return torch.stack([
        dpp_select_tokens(kh, budget, recency, valid_len=vl,
                          method="sample", key=rk)
        for kh, vl, rk in zip(heads, valid, rkeys)])


class KVCompactionClient(ContinuousBatcher):
    """Multi-stream k-DPP KV-compaction coalescer.

    ``budget``/``recency`` are client-level settings. Submit one ticket
    per cache tensor — all its heads ride together — and gather with the
    resolved ``(H, budget)`` positions. Runs on ``device`` (default
    "cuda"; raises without a card unless "cpu" is passed).
    """

    def __init__(self, budget: int, recency: int = 0,
                 config: Optional[ServingConfig] = None, *, tenants=None,
                 seed: int = 0, tracker=None, device: DeviceLike = "cuda"):
        super().__init__(config, tenants=tenants, tracker=tracker,
                         thread_name="repro-serving-kv", device=device)
        if budget <= recency:
            raise ValueError("budget must exceed recency")
        self.budget = int(budget)
        self.recency = int(recency)
        self._keyring = TenantKeyring(seed, device=self.device)

    # -- request path -------------------------------------------------------
    def submit(self, keys, valid_len=None, tenant: str = "default"
               ) -> AsyncTicket:
        """Enqueue one cache tensor's heads: ``keys`` (H, S, d) (a tensor
        or an array), optional ``valid_len`` (scalar or (H,)) marking how
        much of S is real. The ticket resolves to (H, budget) sorted kept
        positions."""
        if not isinstance(keys, torch.Tensor):
            keys = torch.from_numpy(np.asarray(keys))
        keys = keys.to(self.device)
        if keys.dim() != 3:
            raise ValueError(f"expected stacked heads (H, S, d), got shape "
                             f"{tuple(keys.shape)}")
        H, S, _ = keys.shape
        vl = S if valid_len is None else valid_len
        if isinstance(vl, torch.Tensor):
            vl = vl.cpu()
        valid = np.broadcast_to(np.asarray(vl, np.int64), (H,)).tolist()
        t = AsyncTicket(tenant, num_samples=int(H), payload=(keys, valid))
        return self._enqueue(t)

    # -- background flush ---------------------------------------------------
    def _flush(self, batch: List[AsyncTicket], trigger: str) -> None:
        tr = self.tracker
        ext = self._external_tracker()
        span_ext = ext if obs.enabled(ext) else None
        # heads are only batchable at identical (S, d); group, one
        # selection call per group. Under homogeneous traffic (the common
        # case: same model, same cache shape) this is exactly one call.
        groups: "Dict[tuple, List[AsyncTicket]]" = {}
        for t in batch:
            groups.setdefault(tuple(t.payload[0].shape[1:]), []).append(t)
        tr.gauge("serving.shape_groups", len(groups))
        for tickets in groups.values():
            self._flush_group(tickets, trigger, tr, span_ext)

    def _flush_group(self, tickets, trigger, tr, span_ext) -> None:
        t0 = time.perf_counter()
        w0 = time.time()
        total = sum(t.num_samples for t in tickets)
        heads = [h for t in tickets for h in t.payload[0]]
        valid = [v for t in tickets for v in t.payload[1]]
        # the JAX client's keys of the real heads (no pad rows: a row's key
        # does not depend on how many rows follow it)
        rkeys = self._keyring.row_keys(tickets, total)
        t1 = time.perf_counter()
        carrier = tickets[0]
        live = obs.spans.NULL_SPAN if span_ext is None else \
            obs.spans.start_span("device-call", tracker=span_ext,
                                 parent=(carrier.trace_id,
                                         carrier._span_id),
                                 kind="kv-compaction", batch=total,
                                 trigger=trigger, tenant=carrier.tenant)
        with live:
            with tr.timer("serving.device_call_s", kind="kv"):
                picks = _select_heads(heads, valid, rkeys, self.budget,
                                      self.recency)
                if picks.is_cuda:       # the picks are ready at resolve
                    torch.cuda.current_stream(picks.device).synchronize()
        tr.counter("serving.device_calls")
        tr.counter("serving.heads_selected", total)
        t2 = time.perf_counter()
        off = 0
        for t in tickets:
            t._resolve(picks[off: off + t.num_samples])
            off += t.num_samples
        t3 = time.perf_counter()
        for t in tickets:
            tr.observe("serving.latency_s", t3 - t._submitted,
                       tenant=t.tenant)
            tr.observe("serving.queue_wait_s", t0 - t._submitted,
                       tenant=t.tenant)
        tr.gauge("serving.batch_occupancy", total / len(heads))
        tr.gauge("serving.requests_per_flush", len(tickets))
        tr.observe("serving.flush_s", t3 - t0, trigger=trigger,
                   tickets=len(tickets))
        if span_ext is not None:
            emit_flush_spans(span_ext, tickets, carrier, w0, t0, t1, t2, t3,
                             kind="kv-compaction")
