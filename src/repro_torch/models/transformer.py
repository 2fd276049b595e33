"""Model assembly: decoder-only LMs (dense / MoE / SSM / hybrid) and the
whisper-style encoder-decoder, all as stacks of repeating units (port of
``repro/models/transformer.py``).

A "unit" is the smallest repeating block group: one layer for the
homogeneous archs; for jamba ``hybrid_period`` layers (1 attention + 7
mamba, MoE every 2), of which the first ``unit_head`` run directly and the
rest as ``tail_reps`` repeats of a ``unit_tail_period``-layer tail. Params
of all units are stacked on axis 0 (a tail's on axes 0 and 1), with the
JAX package's nested paths and ``(U, …)`` / ``(U, reps, …)`` shapes, so
that a parameter tree crosses between the packages leaf for leaf
(``convert.lm_params_from_numpy``). The JAX package applies the stacks
with ``lax.scan``; here Python loops take each unit's and each repeat's
slice.

Plain functions on tensors: ``LM(cfg, device=)``, ``lm.init_params(key)``,
``lm.forward(params, tokens, enc_embeds=)``, ``lm.loss_fn(params, batch)``,
``lm.prefill(params, tokens, enc_embeds=)``,
``lm.init_decode_state(batch, max_len, enc_embeds=, params=)``,
``lm.decode_step(params, token, state)``. Run the serving ones under
``torch.inference_mode()``. Training takes gradients of ``loss_fn`` with
autograd (``repro_torch.train``); there ``cfg.remat`` wraps each unit in
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), and each
layer too where a unit has more than one, only while grad is enabled.
Each stacked leaf is cut into its units once (``torch.unbind``), so the
backward pass stacks a leaf's unit grads once instead of filling a zero
leaf per unit.

whisper: the encoder runs over the stub frontend's frame embeddings
(``enc_embeds``, (B, encoder_seq, d)); each decoder unit is followed by a
cross-attention layer on the encoder states; a decode step recomputes the
cross K/V from ``DecodeState.enc_out``, as the reference does.

Sharded training and serving pass DTensor params, batches and decode
states (placed by ``repro_torch.distributed.ShardingPolicy``);
``prefill`` and ``decode_step`` enter the params' mesh themselves
(``constraints.sharded_context``), as the train step does. DTensor's
sharding propagation runs the same code, and the families' layers run on
local shards: the dense FFN's hidden dim, MoE experts, SSM heads, and a
decode step's cache write and attention (``distributed/shard_ops.py``). The layout hints of
``repro_torch.distributed.constraints`` (``constrain_bsd`` on each unit's
input, ``constrain_params`` on its params, ``constrain`` on the logits)
sit at the reference's places and return their input unchanged without a
mesh. The embedding lookup and the cross entropy on vocab-sharded
logits are written out on local shards (``distributed/shard_ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .. import random as prng
from .._device import DeviceLike, resolve_device
from ..config import LayerKind, ModelConfig
from ..distributed.constraints import (constrain, constrain_bsd,
                                       constrain_params, sharded_context)
from ..distributed.shard_ops import (embed_lookup, ffn_local, vocab_gold,
                                     vocab_logsumexp)
from .attention import (KVCache, _proj, attention_decode, attention_forward,
                        fill_kv_cache, init_attn_params, init_kv_cache)
from .common import dense_init, embed_init, rms_norm, swiglu
from .moe import init_moe_params, moe_ffn
from .ssm import init_ssm_cache, init_ssm_params, ssm_decode, ssm_forward

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(DTYPES)}")
    return DTYPES[name]


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, tuples and NamedTuples
    (None stays None), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return None if tree is None else fn(tree)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def init_ffn_params(key, cfg: ModelConfig, dtype: torch.dtype,
                    gelu: bool = False):
    d, f = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 3)
    p = {"w_up": dense_init(ks[..., 1, :], (d, f), dtype),
         "w_down": dense_init(ks[..., 2, :], (f, d), dtype, fan_in=f),
         "ln": torch.ones(tuple(ks.shape[:-2]) + (d,), dtype=dtype,
                          device=ks.device)}
    if not gelu:
        p["w_gate"] = dense_init(ks[..., 0, :], (d, f), dtype)
    return p


def _ffn_y(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if "w_gate" in p:
        y = swiglu(h @ p["w_gate"], h @ p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        y = F.gelu((h @ p["w_up"]).float(), approximate="tanh").to(h.dtype)
    return y @ p["w_down"]


def dense_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x + FFN(x); a DTensor ``x`` runs on local shards, the ffn-hidden dim
    over "model" (``shard_ops.ffn_local``)."""
    if isinstance(x, DTensor):
        return ffn_local(lambda xl, pl: _ffn_y(pl, xl, cfg), p, x)
    return x + _ffn_y(p, x, cfg)


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def _unit_layout(cfg: ModelConfig) -> Tuple[int, Tuple[LayerKind, ...]]:
    """(n_units, kinds of the layers inside one unit)."""
    if cfg.hybrid_period:
        period = cfg.hybrid_period
        assert cfg.n_layers % period == 0
        return cfg.n_layers // period, tuple(cfg.layer_kind(i)
                                             for i in range(period))
    # homogeneous: every layer same kind (layer_kind may alternate only via
    # moe_every — fold that into the unit if needed)
    if cfg.n_experts > 0 and cfg.moe_every > 1:
        assert cfg.n_layers % cfg.moe_every == 0
        return (cfg.n_layers // cfg.moe_every,
                tuple(cfg.layer_kind(i) for i in range(cfg.moe_every)))
    return cfg.n_layers, (cfg.layer_kind(0),)


def _unit_split(cfg: ModelConfig):
    """(head_kinds, tail_reps, tail_kinds): a multi-layer unit runs its
    first ``unit_head`` layers directly and the periodic remainder as
    ``tail_reps`` repeats of ``tail_kinds``."""
    _, kinds = _unit_layout(cfg)
    h = cfg.unit_head if cfg.unit_head else len(kinds)
    head, tail = kinds[:h], kinds[h:]
    if not tail:
        return head, 0, ()
    per = cfg.unit_tail_period
    assert per > 0 and len(tail) % per == 0, (per, len(tail))
    tail_kinds = tail[:per]
    for i, k in enumerate(tail):
        assert k == tail_kinds[i % per], "unit tail is not periodic"
    return head, len(tail) // per, tail_kinds


def _init_layers(key, kinds, cfg: ModelConfig, dtype: torch.dtype):
    """Layers of ``kinds`` from a key (..., 2): three keys a layer (k1 the
    mixer, k2 the FFN, the third the next layer's), as the reference."""
    p: Dict[str, Any] = {}
    for j, kind in enumerate(kinds):
        ks = prng.split(key, 3)
        k1, k2, key = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
        layer: Dict[str, Any] = {}
        if kind in (LayerKind.ATTN, LayerKind.ATTN_MOE):
            layer["attn"] = init_attn_params(k1, cfg, dtype)
        else:
            layer["ssm"] = init_ssm_params(k1, cfg, dtype)
        if kind in (LayerKind.ATTN_MOE, LayerKind.SSM_MOE):
            layer["moe"] = init_moe_params(k2, cfg, dtype)
        elif cfg.d_ff > 0:
            layer["ffn"] = init_ffn_params(k2, cfg, dtype,
                                           gelu=cfg.mlp_gelu)
        p[f"layer{j}"] = layer
    return p


def init_unit_params(key, cfg: ModelConfig, dtype: torch.dtype):
    """A unit's params from a key (..., 2); a batch of keys stacks them.
    The tail's ``reps`` repeats stack on the axis after the key's batch."""
    head, reps, tail_kinds = _unit_split(cfg)
    ks = prng.split(key)
    p: Dict[str, Any] = {"head": _init_layers(ks[..., 0, :], head, cfg,
                                              dtype)}
    if reps:
        p["tail"] = _init_layers(prng.split(ks[..., 1, :], reps),
                                 tail_kinds, cfg, dtype)
    return p


def _apply_layer(layer, x, cfg: ModelConfig, collect_cache: bool):
    cache = None
    if "attn" in layer:
        if collect_cache:
            x, (k, v) = attention_forward(layer["attn"], x, cfg,
                                          causal=True, return_kv=True)
            cache = fill_kv_cache(cfg, k, v)
        else:
            x = attention_forward(layer["attn"], x, cfg, causal=True)
    if "ssm" in layer:
        if collect_cache:
            x, cache = ssm_forward(layer["ssm"], x, cfg, return_state=True)
        else:
            x = ssm_forward(layer["ssm"], x, cfg)
    if "moe" in layer:
        x = moe_ffn(layer["moe"], x, cfg)
    if "ffn" in layer:
        x = dense_ffn(layer["ffn"], x, cfg)
    return x, cache


def _apply_layers(p_layers, x, n: int, cfg: ModelConfig,
                  collect_cache: bool, remat_each: bool):
    caches: Dict[str, Any] = {}
    for j in range(n):
        layer = p_layers[f"layer{j}"]
        if remat_each:
            x, c = checkpoint(_apply_layer, layer, x, cfg, collect_cache,
                              use_reentrant=False)
        else:
            x, c = _apply_layer(layer, x, cfg, collect_cache)
        caches[f"layer{j}"] = c
    return x, caches


def apply_unit(p, x: torch.Tensor, cfg: ModelConfig,
               collect_cache: bool = False):
    head, reps, tail_kinds = _unit_split(cfg)
    x = constrain_bsd(x)
    p = constrain_params(p)   # pins the unit's params (and their grads)
    multi = (len(head) + reps * len(tail_kinds)) > 1
    remat_each = cfg.remat and multi and torch.is_grad_enabled()
    x, cache = _apply_layers(p["head"], x, len(head), cfg, collect_cache,
                             remat_each)
    cache = {"head": cache}
    if reps:
        tail = []
        for p_rep in _unstack(p["tail"], reps):
            x = constrain_bsd(x)
            x, c = _apply_layers(constrain_params(p_rep), x,
                                 len(tail_kinds), cfg, collect_cache,
                                 remat_each)
            x = constrain_bsd(x)
            tail.append(c)
        if collect_cache:
            cache["tail"] = _stack(tail)
    if collect_cache:
        return x, cache
    return x


def _init_layer_caches(kinds, cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype, device):
    c: Dict[str, Any] = {}
    for j, kind in enumerate(kinds):
        if kind in (LayerKind.ATTN, LayerKind.ATTN_MOE):
            c[f"layer{j}"] = init_kv_cache(cfg, batch, max_len, dtype,
                                           device)
        else:
            c[f"layer{j}"] = init_ssm_cache(cfg, batch, dtype, device)
    return c


def init_unit_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device):
    head, reps, tail_kinds = _unit_split(cfg)
    c: Dict[str, Any] = {"head": _init_layer_caches(head, cfg, batch,
                                                    max_len, dtype, device)}
    if reps:
        c["tail"] = _stack([_init_layer_caches(tail_kinds, cfg, batch,
                                               max_len, dtype, device)
                            for _ in range(reps)])
    return c


def _decode_layers(p_layers, x, cache, n: int, cfg: ModelConfig):
    new = {}
    for j in range(n):
        layer, key = p_layers[f"layer{j}"], f"layer{j}"
        if "attn" in layer:
            x, new[key] = attention_decode(layer["attn"], x, cache[key], cfg)
        if "ssm" in layer:
            x, new[key] = ssm_decode(layer["ssm"], x, cache[key], cfg)
        if "moe" in layer:
            x = moe_ffn(layer["moe"], x, cfg)
        if "ffn" in layer:
            x = dense_ffn(layer["ffn"], x, cfg)
    return x, new


def apply_unit_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    head, reps, tail_kinds = _unit_split(cfg)
    x, new_head = _decode_layers(p["head"], x, cache["head"], len(head), cfg)
    new = {"head": new_head}
    if reps:
        tail = []
        for r, p_rep in enumerate(_unstack(p["tail"], reps)):
            x, c = _decode_layers(p_rep, x, _index(cache["tail"], r),
                                  len(tail_kinds), cfg)
            tail.append(c)
        new["tail"] = _stack(tail)
    return x, new


def _index(tree, i: int):
    """Every leaf of a stacked tree at index ``i`` of axis 0."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """A tree of leaves stacked on axis 0 (nested dicts) -> the ``n``
    trees of its slices, each leaf unbound once."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][u] for k in tree} for u in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    """Trees of equal structure -> one tree, leaves stacked on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack([t[i] for t in trees])
                             for i in range(len(first))))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Encoder stack (whisper)
# ---------------------------------------------------------------------------

def init_encoder_params(key, cfg: ModelConfig, dtype: torch.dtype):
    ks = prng.split(prng.split(key, cfg.encoder_layers))    # (L, 2, 2)
    return {"attn": init_attn_params(ks[..., 0, :], cfg, dtype),
            "ffn": init_ffn_params(ks[..., 1, :], cfg, dtype, gelu=True)}


def encode(p_enc, embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Audio-frame embeddings (stub frontend output) -> encoder states.
    Bidirectional self-attention (rope'd, as the reference) and the GELU
    FFN a layer; 1500 frames are not a multiple of ``attn_chunk``, so they
    run as one query chunk, as in the reference."""
    h = embeds
    for p in _unstack(p_enc, cfg.encoder_layers):
        h = attention_forward(p["attn"], h, cfg, causal=False)
        h = dense_ffn(p["ffn"], h, cfg)
    return h


def init_cross_params(key, cfg: ModelConfig, dtype: torch.dtype):
    return {"attn": init_attn_params(prng.split(key, cfg.n_layers), cfg,
                                     dtype)}


def _enc_kv(p_cross, enc_out: torch.Tensor, cfg: ModelConfig) -> KVCache:
    """A pseudo-cache holding the encoder K/V for a cross-attention decode
    step (recomputed each step from ``enc_out``, as the reference)."""
    p = p_cross["attn"]
    return KVCache(k=_proj(p, enc_out, cfg, "k", cfg.n_kv_heads),
                   v=_proj(p, enc_out, cfg, "v", cfg.n_kv_heads),
                   pos=torch.zeros((), dtype=torch.int32,
                                   device=enc_out.device))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: Any                      # stacked unit caches
    cross: Optional[Any] = None      # the reference's field; never set
    enc_out: Optional[torch.Tensor] = None   # whisper: encoder states


@dataclasses.dataclass(frozen=True)
class LM:
    """The LM of ``cfg`` on ``device`` (default "cuda"; ``RuntimeError``
    without a card unless "cpu" is passed)."""
    cfg: ModelConfig
    device: DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- init ---------------------------------------------------------------
    def init_params(self, key) -> Dict[str, Any]:
        """Params from a PRNG key (``repro_torch.random``): the JAX
        package's values for the same key, up to ``random.normal``'s ulps."""
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        n_units, _ = _unit_layout(cfg)
        ks = prng.split(prng.as_key(key, self.device), 5)
        unit_keys = prng.split(ks[1], n_units)
        Vp = cfg.vocab_padded
        params: Dict[str, Any] = {
            "embed": embed_init(ks[0], (Vp, cfg.d_model), dtype),
            "blocks": init_unit_params(unit_keys, cfg, dtype),
            "ln_f": torch.ones((cfg.d_model,), dtype=dtype,
                               device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(ks[2], (cfg.d_model, Vp), dtype)
        if cfg.encoder_layers:
            params["encoder"] = init_encoder_params(ks[3], cfg, dtype)
            params["cross"] = init_cross_params(ks[4], cfg, dtype)
        return params

    # -- helpers --------------------------------------------------------------
    def _compute_dtype(self) -> torch.dtype:
        return _dtype(self.cfg.dtype)

    def _cast(self, params):
        """Every float32 leaf with ndim > 1 in the compute dtype (every
        stacked block leaf, norms, biases, routers and SSM constants too;
        the top-level ``ln_f`` stays float32). ``.to`` returns a leaf
        already in that dtype as it is, so casting cast params is free."""
        dt = self._compute_dtype()
        return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32
                        and a.dim() > 1 else a, params)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _units(self, params):
        n_units, _ = _unit_layout(self.cfg)
        units = _unstack(params["blocks"], n_units)
        if not self.cfg.encoder_layers:
            return [(u, None) for u in units]
        return list(zip(units, _unstack(params["cross"], n_units)))

    def _encode(self, params, enc_embeds) -> Optional[torch.Tensor]:
        """The encoder states of ``enc_embeds`` (cast params), or None for
        a decoder-only config."""
        if not self.cfg.encoder_layers:
            return None
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass "
                             f"enc_embeds (B, {self.cfg.encoder_seq}, "
                             f"{self.cfg.d_model})")
        x = enc_embeds if isinstance(enc_embeds, DTensor) else \
            torch.as_tensor(enc_embeds, device=self.device)
        return encode(params["encoder"], x.to(self._compute_dtype()),
                      self.cfg)

    def _head(self, params, h: torch.Tensor, mask_padded: bool = False
              ) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, params["ln_f"], cfg.norm_eps)
        logits = h @ params["embed"].T if cfg.tie_embeddings \
            else h @ params["lm_head"]
        if mask_padded and cfg.vocab_padded != cfg.vocab:
            live = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
            # the scalar takes the logits' dtype, as jnp.asarray(-1e30,
            # logits.dtype)
            logits = torch.where(live, logits, -1e30)
        return logits

    # -- forward (train / prefill without the cache) --------------------------
    def forward(self, params, tokens=None, embeds=None,
                enc_embeds=None) -> torch.Tensor:
        """tokens (B, S) (or ``embeds`` (B, S, d)) -> logits (B, S,
        vocab_padded); ``enc_embeds`` (B, encoder_seq, d) for whisper."""
        cfg = self.cfg
        params = self._cast(params)
        if embeds is None:
            embeds = embed_lookup(params["embed"], self._tokens(tokens))
        x = constrain_bsd(torch.as_tensor(embeds, device=self.device).to(
            self._compute_dtype()))
        enc_out = self._encode(params, enc_embeds)
        remat = cfg.remat and torch.is_grad_enabled()
        for p_unit, p_cross in self._units(params):
            if remat:
                x = checkpoint(apply_unit, p_unit, x, cfg,
                               use_reentrant=False)
            else:
                x = apply_unit(p_unit, x, cfg)
            if p_cross is not None:
                x = attention_forward(p_cross["attn"], x, cfg, causal=False,
                                      kv_from=enc_out)
        return self._head(params, x)

    # -- loss -----------------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch["tokens"]`` (B, S + 1)
        (and ``batch["enc_embeds"]`` for whisper): a float32 scalar. The
        loss is summed over query chunks of min(attn_chunk, S) positions
        (one chunk when S is not a multiple), each chunk's logits in
        float32 with the padded vocab at -1e30, so only one chunk's float32
        logits live at a time."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits = self.forward(params, inputs,
                              enc_embeds=batch.get("enc_embeds"))
        logits = constrain(logits, "batch", None, "model")
        B, S, V = logits.shape
        C = min(cfg.attn_chunk, S)
        n = S // C if S % C == 0 else 1
        C = S if S % C != 0 else C
        live = torch.arange(V, device=logits.device) < cfg.vocab
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i in range(n):
            lg = torch.where(live, logits[:, i * C:(i + 1) * C].float(),
                             -1e30)
            lab = labels[:, i * C:(i + 1) * C]
            if isinstance(lg, DTensor):
                lse, gold = vocab_logsumexp(lg), vocab_gold(lg, lab)
            else:
                lse = torch.logsumexp(lg, dim=-1)
                gold = torch.gather(lg, -1, lab[..., None])[..., 0]
            total = total + torch.sum(lse - gold)
        return total / (B * S)

    # -- prefill (serving): trunk + cache fill + last-token logits -----------
    def prefill(self, params, tokens, enc_embeds=None):
        """tokens (B, S) -> (last logits (B, 1, V), DecodeState)."""
        with sharded_context(params):
            return self._prefill(params, tokens, enc_embeds)

    def _prefill(self, params, tokens, enc_embeds):
        cfg = self.cfg
        params = self._cast(params)
        x = embed_lookup(params["embed"], self._tokens(tokens)).to(
            self._compute_dtype())
        enc_out = self._encode(params, enc_embeds)
        caches = []
        for p_unit, p_cross in self._units(params):
            x, c = apply_unit(p_unit, x, cfg, collect_cache=True)
            caches.append(c)
            if p_cross is not None:
                x = attention_forward(p_cross["attn"], x, cfg, causal=False,
                                      kv_from=enc_out)
        logits = self._head(params, x[:, -1:], mask_padded=True)
        return logits, DecodeState(caches=_stack(caches), enc_out=enc_out)

    # -- serving ------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int, enc_embeds=None,
                          params=None) -> DecodeState:
        """Empty caches for ``batch`` rows of up to ``max_len`` tokens (SWA:
        the window); for whisper the encoder states of ``enc_embeds`` under
        ``params``."""
        n_units, _ = _unit_layout(self.cfg)
        caches = [init_unit_cache(self.cfg, batch, max_len,
                                  self._compute_dtype(), self.device)
                  for _ in range(n_units)]
        enc_out = None
        if self.cfg.encoder_layers:
            with sharded_context(params):
                enc_out = self._encode(self._cast(params), enc_embeds)
        return DecodeState(caches=_stack(caches), enc_out=enc_out)

    def decode_step(self, params, token, state: DecodeState
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """token: (B, 1) int -> (logits (B, 1, V), new state)."""
        with sharded_context(params):
            return self._decode_step(params, token, state)

    def _decode_step(self, params, token, state: DecodeState):
        params = self._cast(params)
        x = embed_lookup(params["embed"], self._tokens(token)).to(
            self._compute_dtype())
        new = []
        for u, (p_unit, p_cross) in enumerate(self._units(params)):
            x, c = apply_unit_decode(p_unit, x, _index(state.caches, u),
                                     self.cfg)
            new.append(c)
            if p_cross is not None:
                x, _ = attention_decode(
                    p_cross["attn"], x, _enc_kv(p_cross, state.enc_out,
                                                self.cfg),
                    self.cfg, kv_from=state.enc_out)
        logits = self._head(params, x, mask_padded=True)
        return logits, DecodeState(_stack(new), state.cross, state.enc_out)
