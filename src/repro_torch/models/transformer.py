"""Model assembly: decoder-only LMs as stacks of repeating units (port of
``repro/models/transformer.py``, for the attention layer kind ``ATTN``).

A "unit" is the smallest repeating block group; for the dense archs it is
one layer. Params of all units are stacked on axis 0, with the JAX
package's nested paths and ``(U, …)`` shapes, so that a parameter tree
crosses between the packages leaf for leaf (``convert.lm_params_from_numpy``).
The JAX package applies the stack with ``lax.scan``; here a Python loop
over units takes each unit's slice.

Plain functions on tensors: ``LM(cfg, device=)``, ``lm.init_params(key)``,
``lm.forward(params, tokens)``, ``lm.loss_fn(params, batch)``,
``lm.prefill(params, tokens)``, ``lm.decode_step(params, token, state)``.
Run the serving ones under ``torch.inference_mode()``. Training takes
gradients of ``loss_fn`` with autograd (``repro_torch.train``); there
``cfg.remat`` wraps each unit in ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``), and only while grad is enabled. Each
stacked leaf is cut into its units once (``torch.unbind``), so the
backward pass stacks a leaf's unit grads once instead of filling a
zero leaf per unit.

Not ported (ROADMAP.md, queue 1): the MoE, SSM and hybrid layer kinds
(``ATTN_MOE``, ``SSM``, ``SSM_MOE``) and whisper's encoder and
cross-attention. ``LM`` refuses such a config with
``NotImplementedError``. The reference's GSPMD sharding hints
(``constrain``, ``constrain_bsd``, ``constrain_heads``, ``constrain_params``
of ``repro/distributed/constraints.py``) do nothing without a mesh and have
no counterpart on one card; they come with the process-group ``Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import random as prng
from .._device import DeviceLike, resolve_device
from ..config import LayerKind, ModelConfig
from .attention import (attention_decode, attention_forward, fill_kv_cache,
                        init_attn_params, init_kv_cache)
from .common import dense_init, embed_init, rms_norm, swiglu

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


def dense_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if "w_gate" in p:
        y = swiglu(h @ p["w_gate"], h @ p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        y = F.gelu((h @ p["w_up"]).float(), approximate="tanh").to(h.dtype)
    return x + y @ p["w_down"]


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


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose layers the port
    does not have yet."""
    _, kinds = _unit_layout(cfg)
    other = sorted({k.value for k in kinds} - {LayerKind.ATTN.value})
    if other or cfg.encoder_layers:
        what = ", ".join(other + (["an encoder"] if cfg.encoder_layers
                                  else []))
        raise NotImplementedError(
            f"{cfg.name}: {what} layers are not ported yet; the port has the "
            f"decoder-only attention layers (ROADMAP.md, queue 1: the "
            f"remaining model families)")


def _init_layers(key, kinds, cfg: ModelConfig, dtype: torch.dtype):
    p: Dict[str, Any] = {}
    for j, _ in enumerate(kinds):
        ks = prng.split(key, 3)
        key = ks[..., 2, :]
        layer = {"attn": init_attn_params(ks[..., 0, :], cfg, dtype)}
        if cfg.d_ff > 0:
            layer["ffn"] = init_ffn_params(ks[..., 1, :], cfg, dtype,
                                           gelu=cfg.mlp_gelu)
        p[f"layer{j}"] = layer
    return p


def init_unit_params(key, cfg: ModelConfig, dtype: torch.dtype):
    """A unit's params from a key (..., 2); a batch of keys stacks them."""
    head, _, _ = _unit_split(cfg)
    k1 = prng.split(key)[..., 0, :]
    return {"head": _init_layers(k1, head, cfg, dtype)}


def _apply_layer(layer, x, cfg: ModelConfig, collect_cache: bool):
    cache = None
    if collect_cache:
        x, (k, v) = attention_forward(layer["attn"], x, cfg, causal=True,
                                      return_kv=True)
        cache = fill_kv_cache(cfg, k, v)
    else:
        x = attention_forward(layer["attn"], x, cfg, causal=True)
    if "ffn" in layer:
        x = dense_ffn(layer["ffn"], x, cfg)
    return x, cache


def apply_unit(p, x: torch.Tensor, cfg: ModelConfig,
               collect_cache: bool = False):
    head, _, _ = _unit_split(cfg)
    caches: Dict[str, Any] = {}
    for j in range(len(head)):
        x, c = _apply_layer(p["head"][f"layer{j}"], x, cfg, collect_cache)
        caches[f"layer{j}"] = c
    if collect_cache:
        return x, {"head": caches}
    return x


def init_unit_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device):
    head, _, _ = _unit_split(cfg)
    return {"head": {f"layer{j}": init_kv_cache(cfg, batch, max_len, dtype,
                                                device)
                     for j in range(len(head))}}


def apply_unit_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    head, _, _ = _unit_split(cfg)
    new = {}
    for j in range(len(head)):
        layer, key = p["head"][f"layer{j}"], f"layer{j}"
        x, new[key] = attention_decode(layer["attn"], x, cache["head"][key],
                                       cfg)
        if "ffn" in layer:
            x = dense_ffn(layer["ffn"], x, cfg)
    return x, {"head": new}


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
# Full model
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: Any                      # stacked unit caches
    cross: Optional[Any] = None      # whisper's cross KV: not ported
    enc_out: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class LM:
    """The decoder-only LM of ``cfg`` on ``device`` (default "cuda";
    ``RuntimeError`` without a card unless "cpu" is passed)."""
    cfg: ModelConfig
    device: DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        check_ported(self.cfg)

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
        return params

    # -- helpers --------------------------------------------------------------
    def _compute_dtype(self) -> torch.dtype:
        return _dtype(self.cfg.dtype)

    def _cast(self, params):
        """Every float32 leaf with ndim > 1 in the compute dtype (every
        stacked block leaf, norms and biases too; the top-level ``ln_f``
        stays float32). ``.to`` returns a leaf already in that dtype as it
        is, so casting cast params is free."""
        dt = self._compute_dtype()
        return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32
                        and a.dim() > 1 else a, params)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _units(self, params):
        n_units, _ = _unit_layout(self.cfg)
        return _unstack(params["blocks"], n_units)

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
    def forward(self, params, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab_padded)."""
        cfg = self.cfg
        params = self._cast(params)
        x = params["embed"][self._tokens(tokens)].to(self._compute_dtype())
        remat = cfg.remat and torch.is_grad_enabled()
        for p_unit in self._units(params):
            if remat:
                x = checkpoint(apply_unit, p_unit, x, cfg,
                               use_reentrant=False)
            else:
                x = apply_unit(p_unit, x, cfg)
        return self._head(params, x)

    # -- loss -----------------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch["tokens"]`` (B, S + 1):
        a float32 scalar. The loss is summed over query chunks of
        min(attn_chunk, S) positions (one chunk when S is not a multiple),
        each chunk's logits in float32 with the padded vocab at -1e30, so
        only one chunk's float32 logits live at a time."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits = self.forward(params, inputs)
        B, S, V = logits.shape
        C = min(cfg.attn_chunk, S)
        n = S // C if S % C == 0 else 1
        C = S if S % C != 0 else C
        live = torch.arange(V, device=logits.device) < cfg.vocab
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i in range(n):
            lg = torch.where(live, logits[:, i * C:(i + 1) * C].float(),
                             -1e30)
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1,
                                labels[:, i * C:(i + 1) * C, None])[..., 0]
            total = total + torch.sum(lse - gold)
        return total / (B * S)

    # -- prefill (serving): trunk + cache fill + last-token logits -----------
    def prefill(self, params, tokens):
        """tokens (B, S) -> (last logits (B, 1, V), DecodeState)."""
        params = self._cast(params)
        x = params["embed"][self._tokens(tokens)].to(self._compute_dtype())
        caches = []
        for p_unit in self._units(params):
            x, c = apply_unit(p_unit, x, self.cfg, collect_cache=True)
            caches.append(c)
        logits = self._head(params, x[:, -1:], mask_padded=True)
        return logits, DecodeState(caches=_stack(caches))

    # -- serving ------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int) -> DecodeState:
        n_units, _ = _unit_layout(self.cfg)
        caches = [init_unit_cache(self.cfg, batch, max_len,
                                  self._compute_dtype(), self.device)
                  for _ in range(n_units)]
        return DecodeState(caches=_stack(caches))

    def decode_step(self, params, token, state: DecodeState
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """token: (B, 1) int -> (logits (B, 1, V), new state)."""
        params = self._cast(params)
        x = params["embed"][self._tokens(token)].to(self._compute_dtype())
        new = []
        for u, p_unit in enumerate(self._units(params)):
            cache = tree_map(lambda a, u=u: a[u], state.caches)
            x, c = apply_unit_decode(p_unit, x, cache, self.cfg)
            new.append(c)
        logits = self._head(params, x, mask_padded=True)
        return logits, DecodeState(_stack(new), state.cross, state.enc_out)
