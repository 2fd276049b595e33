"""DPP KV-cache compaction — Diversity-Networks applied to cached tokens
(port of ``repro/serve/kv_compaction.py``).

When a full-attention KV cache exceeds its budget, keep the most *diverse*
key subset (plus a recency window): build an L-kernel over key vectors and
either take the greedy k-DPP MAP (Chen et al. 2018 fast greedy through the
fused greedy-MAP kernel, ``method="map"``) or draw an *exact* k-DPP sample
(``method="sample"``: one ``eigh`` of the head's kernel, the ESP phase 1
and one ``phase2_select`` call at m = 1). Diversity-preserving eviction
retains long-range anchors that recency-only eviction drops.

``dpp_select_tokens`` selects for one head. The JAX ``compact_kv_cache``
vmaps it over a layer's (batch, KV head) pairs inside a trace; here
``"map"`` builds each head's kernel, stacks them and runs one batched
``greedy_map_kdpp`` (one launch on the card) for the whole layer, and
``"sample"`` runs one call per head, as ``serving.kv`` does for a coalesced
flush. The selection runs on the keys' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import random as prng
from ..dpp.functional import greedy_map_kdpp, sample_kdpp_dense
from ..models.attention import KVCache


def token_kernel(keys: torch.Tensor, recency: int = 0,
                 valid_len: Optional[int] = None, method: str = "map"):
    """The L-kernel (S, S) float32 that ``dpp_select_tokens`` selects from
    for one head's keys (S, d), the selectable positions (S,) bool and the
    valid length: cosine similarities plus a 1e-4 ridge, with the recency
    window and the invalid tail excluded — exactly zeroed for
    ``method="sample"``, a 1e-6 diagonal for ``"map"``."""
    S, _ = keys.shape
    dev = keys.device
    kf = keys.to(torch.float32)
    kf = kf / (torch.linalg.norm(kf, dim=-1, keepdim=True) + 1e-6)
    eye = torch.eye(S, dtype=torch.float32, device=dev)
    L = kf @ kf.T + 1e-4 * eye
    # the recency window is force-kept by dpp_select_tokens, so it must be
    # excluded from DPP selection even when the whole cache is valid —
    # otherwise picks duplicate recent positions and waste budget slots
    vl = S if valid_len is None else int(valid_len)
    sel_ok = torch.arange(S, device=dev) < (vl - recency)
    both = sel_ok[:, None] & sel_ok[None, :]
    if method == "sample":
        # Hard exclusion: excluded slots must get *exactly* zero eigenvalue
        # mass — a tiny ridge (safe for greedy argmax) leaks under an exact
        # k-DPP draw whenever k_dpp exceeds the valid keys' numerical rank,
        # and a leaked slot means a duplicated recency token or a garbage
        # key attending in decode.
        return torch.where(both, L, 0.0), sel_ok, vl
    # soft exclusion (diag -> tiny conditional variance) is enough for the
    # deterministic argmax; a no-op when sel_ok is all-True
    return torch.where(both, L, torch.where(eye.bool(), 1e-6, 0.0)), \
        sel_ok, vl


def dpp_select_tokens(keys: torch.Tensor, budget: int, recency: int = 0,
                      valid_len: Optional[int] = None, method: str = "map",
                      key=None) -> torch.Tensor:
    """Pick ``budget`` diverse token positions from keys (S, d).

    recency: that many most-recent positions are always kept; the DPP picks
    the remaining budget-recency from the older region.
    method: "map" (deterministic greedy MAP) or "sample" (exact k-DPP draw;
    requires ``key``, a PRNG key of ``repro_torch.random`` or the JAX
    package's uint32 key, whose draw it reproduces).
    Returns sorted (budget,) int32 positions on the keys' device.
    """
    S, _ = keys.shape
    dev = keys.device
    k_dpp = budget - recency
    if method == "sample" and key is None:
        raise ValueError("method='sample' needs a PRNG key")
    L, sel_ok, vl = token_kernel(keys, recency, valid_len, method)
    if method == "sample":
        sampled = sample_kdpp_dense(key, L, k_dpp)    # -1-padded if rank < k
        # Fixed-shape fallback: keep every sampled position, fill any -1
        # slots with the most recent unsampled selectable positions.
        hit = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
        hit[torch.where(sampled >= 0, sampled, S).long()] = True
        pos = torch.arange(S, device=dev, dtype=torch.float32)
        score = torch.where(hit[:S], 2.0 * S,
                            torch.where(sel_ok, pos, -1.0))
        # jax.lax.top_k: the larger value first, the lower index among
        # equal values; a stable descending sort keeps that order
        picks = torch.sort(score, descending=True, stable=True
                           ).indices[:k_dpp].to(torch.int32)
    else:
        picks = greedy_map_kdpp(L, k_dpp)
    if recency > 0:
        recent = vl - 1 - torch.arange(recency, device=dev)
        picks = torch.cat([picks, recent.to(torch.int32)])
    return torch.sort(picks).values


def compact_kv_cache(cache: KVCache, budget: int, recency: int = 64,
                     method: str = "map", key=None
                     ) -> Tuple[KVCache, torch.Tensor]:
    """Compact one layer's cache (B, S, KV, hd) down to (B, budget, KV, hd).

    Selection is per (batch, kv-head) on the key vectors; returns the new
    cache and the kept positions (B, KV, budget) int32 for position
    bookkeeping. method="sample" draws an exact k-DPP per head (needs
    ``key``; head (b, h) takes ``split(key, (B, KV))[b, h]``, the JAX
    package's key) instead of the deterministic greedy MAP.
    """
    B, S, KV, hd = cache.k.shape
    vl = int(cache.pos)
    if method == "sample":
        if key is None:
            raise ValueError("method='sample' needs a PRNG key")
        hkeys = prng.split(prng.as_key(key, cache.k.device), (B, KV))
        picks = torch.stack([torch.stack([
            dpp_select_tokens(cache.k[b, :, h], budget, recency,
                              valid_len=vl, method=method, key=hkeys[b, h])
            for h in range(KV)]) for b in range(B)])         # (B, KV, bud)
    else:
        # every head's kernel, bitwise as dpp_select_tokens builds it, then
        # one greedy MAP over the (B·KV, S, S) stack: the reference's vmap
        Ls = torch.stack([token_kernel(cache.k[b, :, h], recency, vl)[0]
                          for b in range(B) for h in range(KV)])
        picks = greedy_map_kdpp(Ls, budget - recency)       # (B·KV, k)
        if recency > 0:
            recent = vl - 1 - torch.arange(recency, device=picks.device)
            picks = torch.cat([picks, recent.to(torch.int32).expand(
                B * KV, recency)], dim=1)
        picks = torch.sort(picks, dim=1).values.reshape(B, KV, budget)
    # (B, S, KV, hd) gathered along S at picks (B, KV, budget)
    idx = picks.transpose(1, 2).long()[..., None].expand(B, budget, KV, hd)
    return KVCache(k=torch.gather(cache.k, 1, idx),
                   v=torch.gather(cache.v, 1, idx), pos=cache.pos), picks
