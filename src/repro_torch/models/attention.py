"""GQA attention: chunked (memory-bounded) train/prefill path + cached decode
(port of ``repro/models/attention.py``).

The S×S score matrix is never materialized. Queries are processed in
chunks of ``cfg.attn_chunk`` (a Python loop where the JAX package scans);
each chunk attends either to the full key set (masked, full attention) or
to a fixed-width sliding band (SWA archs — FLOPs linear in S). Scores are
fp32: the JAX package multiplies its activation-dtype operands with fp32
accumulation (``preferred_element_type``); here q and k are upcast before
the product (a bfloat16 product is exact in float32, and TF32 is off), and
the PV product takes the probabilities in v's dtype, accumulates in fp32
and casts to q's dtype, as there.

Cross-attention (``kv_from``, whisper's decoder): K and V come from the
un-normed encoder states, no rotary embedding on either side, every
encoder position attended; a decode step attends the encoder K/V that
``LM.decode_step`` recomputes each step, and returns that pseudo-cache
unchanged.

``attention_decode`` is functional, as the reference: it returns a new
cache and leaves the one it was given as it was. The slot ``pos % size``
stays a device tensor, and no constant is copied from the host (a
``torch.tensor(..., device=card)`` copy waits for the card), so a decode
step never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import random as prng
from ..config import ModelConfig
from .common import dense_init, rms_norm, rope, seq_map, stable_softmax


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_cache, KV, Dh)
    v: torch.Tensor        # (B, S_cache, KV, Dh)
    pos: torch.Tensor      # () int32 — tokens already cached (ring: logical)


def init_attn_params(key, cfg: ModelConfig, dtype: torch.dtype):
    """One layer's attention weights from a key (..., 2); a batch of keys
    gives leaves stacked over its shape (the JAX package's ``vmap``)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = prng.split(key, 5)
    batch = tuple(ks.shape[:-2])
    dev = ks.device
    p = {
        "wq": dense_init(ks[..., 0, :], (d, H * hd), dtype),
        "wk": dense_init(ks[..., 1, :], (d, KV * hd), dtype),
        "wv": dense_init(ks[..., 2, :], (d, KV * hd), dtype),
        "wo": dense_init(ks[..., 3, :], (H * hd, d), dtype),
        "ln": torch.ones(batch + (d,), dtype=dtype, device=dev),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(batch + (width,), dtype=dtype, device=dev)
    return p


def _proj(p, x: torch.Tensor, cfg: ModelConfig, name: str, heads: int
          ) -> torch.Tensor:
    """x @ w{name} (+ b{name}) as (B, S, heads, hd)."""
    B, S, _ = x.shape
    y = x @ p[f"w{name}"]
    if cfg.qkv_bias:
        y = y + p[f"b{name}"]
    return y.reshape(B, S, heads, cfg.hd)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig):
    return (_proj(p, x, cfg, "q", cfg.n_heads),
            _proj(p, x, cfg, "k", cfg.n_kv_heads),
            _proj(p, x, cfg, "v", cfg.n_kv_heads))


def _chunk_attend(q, k, v, q_pos, k_pos, *, causal: bool, scale: float,
                  window: Optional[int] = None) -> torch.Tensor:
    """One query chunk vs a key slab. q: (B,Cq,H,hd), k/v: (B,Sk,KV,hd).

    q_pos: (Cq,) global query positions; k_pos: (Sk,) global key positions
    (may include invalid = -1 entries which are masked out).
    """
    B, Cq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, Cq, KV, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    mask = (k_pos[None, :] >= 0)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    probs = stable_softmax(scores, mask[None, None, None])
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Cq, H * hd).to(q.dtype)


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                      causal: bool = True,
                      kv_from: Optional[torch.Tensor] = None,
                      return_kv: bool = False):
    """Full-sequence attention (train / prefill), chunked over queries.

    kv_from: optional encoder states for cross-attention (B, S_enc, d).
    return_kv: prefill mode — also return the rope'd (k, v) for cache fill.
    """
    B, S, _ = x.shape
    dev = x.device
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    scale = cfg.hd ** -0.5
    if kv_from is None:
        q, k, v = _qkv(p, h, cfg)
        pos = torch.arange(S, device=dev)
        q = rope(q, pos[None, :], cfg.rope_theta)
        k = rope(k, pos[None, :], cfg.rope_theta)
        self_attn = True
    else:
        q = _proj(p, h, cfg, "q", cfg.n_heads)
        k = _proj(p, kv_from, cfg, "k", cfg.n_kv_heads)
        v = _proj(p, kv_from, cfg, "v", cfg.n_kv_heads)
        pos = torch.arange(kv_from.shape[1], device=dev)
        self_attn = False

    C = min(cfg.attn_chunk, S)
    n_chunks = S // C
    if S % C != 0:
        C = S
        n_chunks = 1

    W = cfg.sliding_window
    if W is not None and causal and self_attn and S > W + C:
        # Banded SWA: per q-chunk, slice a fixed (W + C)-wide key band
        # (its start clamped into [0, S - band], as dynamic_slice does).
        band = W + C

        def band_chunk(i):
            start = min(max(i * C + C - band, 0), S - band)
            q_pos = i * C + torch.arange(C, device=dev)
            k_pos = start + torch.arange(band, device=dev)
            return _chunk_attend(q[:, i * C:(i + 1) * C],
                                 k[:, start:start + band],
                                 v[:, start:start + band], q_pos, k_pos,
                                 causal=True, scale=scale, window=W)

        outs = seq_map(band_chunk, n_chunks)
    else:
        def full_chunk(i):
            q_pos = i * C + torch.arange(C, device=dev)
            return _chunk_attend(q[:, i * C:(i + 1) * C], k, v, q_pos, pos,
                                 causal=causal, scale=scale,
                                 window=W if causal and self_attn else None)

        outs = seq_map(full_chunk, n_chunks)
    out = outs.transpose(0, 1).reshape(B, S, -1)

    y = x + out @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def fill_kv_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor
                  ) -> KVCache:
    """Turn prefill (k, v) of length S into a decode-ready cache.

    Full attention: cache slots [0..S). SWA: ring buffer of the last W keys,
    placed so slot s holds logical position p ≡ s (mod W).
    """
    S = k.shape[1]
    W = cfg.sliding_window
    pos = torch.full((), S, dtype=torch.int32, device=k.device)
    if W is None or S <= W:
        return KVCache(k=k, v=v, pos=pos)
    shift = S % W
    return KVCache(k=torch.roll(k[:, S - W:], shift, dims=1),
                   v=torch.roll(v[:, S - W:], shift, dims=1), pos=pos)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> KVCache:
    """Cache sized to min(max_len, window) — SWA archs get a ring buffer."""
    size = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    KV, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def attention_decode(p, x: torch.Tensor, cache: KVCache, cfg: ModelConfig,
                     kv_from: Optional[torch.Tensor] = None):
    """One-token decode. x: (B, 1, d). Returns (y, new_cache).

    kv_from: the encoder states; ``cache`` then holds their K/V (every
    position attended, ``q_pos`` 10**9 as the reference), and comes back
    unchanged."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    scale = cfg.hd ** -0.5
    if kv_from is not None:
        q = _proj(p, h, cfg, "q", cfg.n_heads)
        k_pos = torch.arange(cache.k.shape[1], device=x.device)
        q_pos = torch.full((1,), 10 ** 9, dtype=torch.int64, device=x.device)
        out = _chunk_attend(q, cache.k, cache.v, q_pos, k_pos, causal=False,
                            scale=scale)
        return x + out @ p["wo"], cache
    q, k_new, v_new = _qkv(p, h, cfg)
    pos = cache.pos

    q = rope(q, pos[None, None], cfg.rope_theta)
    k_new = rope(k_new, pos[None, None], cfg.rope_theta)
    size = cache.k.shape[1]
    slot = torch.remainder(pos, size)          # ring for SWA, linear else
    at = slot.reshape(1).long()
    k = cache.k.index_copy(1, at, k_new)
    v = cache.v.index_copy(1, at, v_new)
    idx = torch.arange(size, device=x.device)
    if cfg.sliding_window is None:
        k_pos = torch.where(idx <= pos, idx, -1)
    else:
        # ring buffer: slot s holds logical position p where p ≡ s (mod size)
        age = torch.remainder(slot - idx, size)
        logical = pos - age
        k_pos = torch.where((logical >= 0) & (logical > pos - size),
                            logical, -1)
    out = _chunk_attend(q, k, v, pos.reshape(1), k_pos, causal=True,
                        scale=scale)
    return x + out @ p["wo"], KVCache(k, v, pos + 1)
