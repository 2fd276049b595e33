"""Serving engine: batched prefill + decode loop with optional DPP KV
compaction, greedy/temperature sampling, and per-request bookkeeping
(port of ``repro/serve/engine.py``).

KV compaction (``compact_kv`` / ``generate(kv_budget=...)``) has two
paths: inline (this engine draws its own PRNG keys and compacts each
cache tensor head by head) and coalesced — pass a
``repro_torch.serving.KVCompactionClient`` and every layer's heads are
submitted as async tickets, so concurrent decode streams compacting at
the same moment share one flush.

The JAX engine jits ``prefill`` and ``decode_step``; here they run eagerly
under ``torch.inference_mode()``, one launch per operation: a decode step
of qwen2-0.5b is about 20 launches a layer, and no step waits for the
device (the cache slot stays a device tensor). Keys come from
``repro_torch.random``, so a seed gives the JAX engine's keys.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import random as prng
from .._device import DeviceLike, resolve_device
from ..models import LM, DecodeState, KVCache
from .kv_compaction import compact_kv_cache


def _cache_leaves(tree) -> List[KVCache]:
    """The ``KVCache`` leaves of a cache tree, dict keys in sorted order
    (the order of ``jax.tree_util.tree_flatten``, which fixes the order of
    the compaction keys)."""
    if isinstance(tree, KVCache):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _cache_leaves(tree[k])]


def _replace_leaves(tree, leaves):
    """``tree`` with its ``KVCache`` leaves taken in turn from the iterator
    ``leaves`` (``_cache_leaves``'s order)."""
    if isinstance(tree, KVCache):
        return next(leaves)
    return {k: _replace_leaves(tree[k], leaves) for k in sorted(tree)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeEngine:
    """Generation with ``lm`` and ``params`` on ``device`` (default "cuda";
    ``RuntimeError`` without a card unless "cpu" is passed)."""
    lm: LM
    params: dict
    temperature: float = 0.0
    seed: int = 0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device != self.lm.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"LM's {self.lm.device}")
        # The JAX engine casts the float32 params to the compute dtype
        # inside every jitted prefill and decode call; casting them once
        # here gives the same values, and the LM's own cast of cast params
        # is free.
        self.params = self.lm._cast(self.params)
        self._key = prng.PRNGKey(self.seed, self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1).to(torch.int32)
        keys = prng.split(self._key)
        self._key, sub = keys[0], keys[1]
        # JAX divides by the temperature rounded to the logits' dtype (a
        # host scalar: no copy to the card, no wait)
        t = float(torch.tensor(self.temperature).to(logits.dtype))
        return prng.categorical(sub, logits / t, axis=-1).to(torch.int32)

    def compact_kv(self, state: DecodeState, budget: Optional[int] = None,
                   recency: int = 8, method: str = "sample",
                   client=None, tenant: str = "default",
                   timeout: float = 120.0) -> DecodeState:
        """Compact every self-attention KV cache in ``state`` to ``budget``
        diverse + recent token slots (Diversity-Networks eviction).

        Inline path (``client=None``): each cache tensor is compacted via
        ``kv_compaction.compact_kv_cache`` with engine-owned PRNG keys: one
        split of the engine key, then one split a unit, then
        ``split(sub, (B, KV))`` inside ``compact_kv_cache`` — the JAX
        engine's order, so the same seed keeps the same tokens.

        Coalesced path: pass a ``repro_torch.serving.KVCompactionClient`` —
        the heads of every layer are submitted as async tickets (tagged
        ``tenant=``), in the order (U·B·KV, S, hd), and this call blocks on
        the resolved picks. The client's static ``budget``/``recency`` are
        authoritative; passing conflicting values raises.

        The cache keeps ``pos`` (the tokens seen): the next decode step
        writes slot ``pos % budget``, over a kept token, as the JAX engine
        does.
        """
        if client is not None:
            if budget is not None and budget != client.budget:
                raise ValueError(
                    f"budget {budget} conflicts with the client's static "
                    f"budget {client.budget}")
            budget = client.budget
            recency = client.recency
        elif budget is None:
            raise ValueError("compact_kv needs a budget (or a client)")

        leaves = _cache_leaves(state.caches)
        new_leaves: List[KVCache] = []
        if client is not None:
            # submit EVERY leaf first, then resolve — all layers of this
            # stream ride one flush window and can coalesce with other
            # streams' layers
            tickets = []
            for leaf in leaves:
                U, B, S, KV, hd = leaf.k.shape      # stacked units
                heads = leaf.k.permute(0, 1, 3, 2, 4).reshape(U * B * KV, S,
                                                              hd)
                valid = leaf.pos.to(torch.int32).reshape(U).repeat_interleave(
                    B * KV)
                tickets.append(client.submit(heads, valid_len=valid,
                                             tenant=tenant))
            for leaf, ticket in zip(leaves, tickets):
                picks = ticket.result(timeout)          # (H, budget)
                U, B, S, KV, hd = leaf.k.shape
                idx = picks.to(leaf.k.device).reshape(U, B, KV, budget
                                                      ).transpose(2, 3)
                idx = idx.long()[..., None].expand(U, B, budget, KV, hd)
                new_leaves.append(KVCache(k=torch.gather(leaf.k, 2, idx),
                                          v=torch.gather(leaf.v, 2, idx),
                                          pos=leaf.pos))
        else:
            key = None
            if method == "sample":
                keys = prng.split(self._key)
                self._key, key = keys[0], keys[1]
            for leaf in leaves:
                ks, vs = [], []
                for u in range(leaf.k.shape[0]):
                    sub = None
                    if key is not None:
                        keys = prng.split(key)
                        key, sub = keys[0], keys[1]
                    nc, _ = compact_kv_cache(
                        KVCache(leaf.k[u], leaf.v[u], leaf.pos[u]), budget,
                        recency, method, key=sub)
                    ks.append(nc.k)
                    vs.append(nc.v)
                new_leaves.append(KVCache(torch.stack(ks), torch.stack(vs),
                                          leaf.pos))
        caches = _replace_leaves(state.caches, iter(new_leaves))
        return DecodeState(caches, state.cross, state.enc_out)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 stop_token: Optional[int] = None,
                 kv_budget: Optional[int] = None, kv_recency: int = 8,
                 kv_method: str = "sample", kv_client=None,
                 kv_tenant: str = "default") -> Dict:
        """prompts: (B, S_prompt) int32 -> dict with tokens + timing.

        ``kv_budget`` (or ``kv_client``) compacts the KV cache between
        prefill and decode — see ``compact_kv``. Times are host clock
        around work that ends in a device synchronize."""
        t0 = time.perf_counter()
        logits, state = self.lm.prefill(self.params, prompts)
        tok = self._sample(logits[:, -1])
        _sync(self.device)
        t_prefill = time.perf_counter() - t0

        t_compact = 0.0
        if kv_budget is not None or kv_client is not None:
            tc = time.perf_counter()
            state = self.compact_kv(state, kv_budget, kv_recency,
                                    kv_method, client=kv_client,
                                    tenant=kv_tenant)
            _sync(self.device)
            t_compact = time.perf_counter() - tc

        out: List[torch.Tensor] = [tok]
        done = np.zeros(prompts.shape[0], bool)
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, state = self.lm.decode_step(self.params, tok[:, None],
                                                state)
            tok = self._sample(logits[:, -1])
            out.append(tok)
            if stop_token is not None:
                done |= tok.cpu().numpy() == stop_token
                if done.all():
                    break
        _sync(self.device)
        t_decode = time.perf_counter() - t1
        tokens = torch.stack(out, dim=1).cpu().numpy()
        return {"tokens": tokens,
                "prefill_s": t_prefill,
                "compact_s": t_compact,
                "decode_s": t_decode,
                "decode_tok_per_s": tokens.shape[0] * tokens.shape[1]
                                    / max(t_decode, 1e-9)}
