"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060; port of
``repro/models/ssm.py``).

Prefill uses the chunked dual form: an intra-chunk quadratic term over
(chunk × chunk) tiles and an inter-chunk linear state recurrence (a
Python loop over the chunks where the JAX package scans). Decode is the
O(1) recurrent update. The chunk terms are einsums, as the XLA einsums of
the JAX package (no Pallas kernel there).

Every cast stands where the reference has it: the prefill's conv SiLU runs
in the compute dtype, the decode's in float32 and back; the SSD terms and
the state are float32, the chunk outputs are cast to the compute dtype
before the (cast) D term is added. Under bfloat16 compute ``A_log``, ``D``
and ``dt_bias`` are bfloat16 too (their stacked leaves are 2-D, which
``LM._cast`` casts), so ``-exp(A_log)`` is a bfloat16 exp, as there.

n_groups = 1. Head layout: d_inner = expand · d_model split into
nh = d_inner / ssm_head_dim heads of hp dims.

Sharded, a DTensor layer input runs on local shards
(``distributed.shard_ops.ssm_local``): each rank its batch rows and its
heads, from this rank's columns of the gathered in_proj and conv (z, x
and dt of its heads; B and C, which every head reads); the gated RMSNorm
over d_inner sums its squares over "model" (``_gated_norm``); the out
projection of the rank's heads is its share of a sum over "model". A
prefill returns the conv window's channels of this rank's shard (a
3-token product of their in_proj columns), a decode step computes every
conv channel (one token) and keeps its shard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .. import random as prng
from ..config import ModelConfig
from ..distributed.constraints import constrain
from ..distributed.shard_ops import ssm_local
from .common import dense_init, rms_norm


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, k-1, conv_dim) rolling conv window
    state: torch.Tensor    # (B, nh, hp, N) SSM state, float32
    pos: torch.Tensor      # () int32


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    hp = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = di + 2 * N          # x, B, C channels go through the conv
    return di, nh, hp, N, conv_dim


def init_ssm_params(key, cfg: ModelConfig, dtype: torch.dtype):
    """One layer's SSM weights from a key (..., 2); a batch of keys stacks
    them. ``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``dtype``."""
    d = cfg.d_model
    di, nh, hp, N, conv_dim = _dims(cfg)
    ks = prng.split(key, 4)
    batch = tuple(ks.shape[:-2])
    dev = ks.device
    in_dim = 2 * di + 2 * N + nh   # z, x, B, C, dt

    def const(v: torch.Tensor) -> torch.Tensor:
        return v.to(dev).expand(batch + v.shape).clone()

    f32 = torch.float32
    return {
        "in_proj": dense_init(ks[..., 0, :], (d, in_dim), dtype),
        "conv_w": dense_init(ks[..., 1, :], (cfg.ssm_conv, conv_dim), dtype,
                             fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(batch + (conv_dim,), dtype=dtype, device=dev),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32))),
        "D": torch.ones(batch + (nh,), dtype=f32, device=dev),
        "dt_bias": const(torch.log(torch.expm1(torch.full((nh,), 0.01,
                                                          dtype=f32)))),
        "norm": torch.ones(batch + (di,), dtype=dtype, device=dev),
        "out_proj": dense_init(ks[..., 2, :], (di, d), dtype),
        "ln": torch.ones(batch + (d,), dtype=dtype, device=dev),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via k shifted adds. u: (B, S, C), w: (k, C)."""
    k, S = w.shape[0], u.shape[1]
    out = u * w[-1]
    for t in range(1, k):
        shifted = F.pad(u, (0, 0, t, 0))[:, :S]
        out = out + shifted * w[-1 - t]
    return F.silu(out + b)


def _split(p, h: torch.Tensor, cfg: ModelConfig):
    di, nh, hp, N, conv_dim = _dims(cfg)
    zxbcdt = h @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: di + conv_dim]
    dt_raw = zxbcdt[..., di + conv_dim:]
    return z, xBC, dt_raw


def _heads_cols(cfg: ModelConfig, h0: int, n: int):
    """Column slices of in_proj of heads h0 .. h0 + n - 1: (z, x, B and C
    together, dt), each a ``slice``."""
    di, nh, hp, N, conv_dim = _dims(cfg)
    return (slice(h0 * hp, (h0 + n) * hp),
            slice(di + h0 * hp, di + (h0 + n) * hp),
            slice(2 * di, 2 * di + 2 * N),
            slice(di + conv_dim + h0, di + conv_dim + h0 + n))


def _local_params(p, cfg: ModelConfig, h0: int, n: int):
    """The gathered params cut to heads h0 .. h0 + n - 1: in_proj's (z,
    xBC, dt) columns, the conv's channels (x of these heads, B, C), the
    per-head constants, the norm's and out_proj's rows."""
    di, nh, hp, N, conv_dim = _dims(cfg)
    cz, cx, cbc, cdt = _heads_cols(cfg, h0, n)
    w = p["in_proj"]
    chans = torch.cat([torch.arange(cx.start - di, cx.stop - di,
                                    device=w.device),
                       torch.arange(di, conv_dim, device=w.device)])
    rows = slice(h0 * hp, (h0 + n) * hp)
    return {"w_z": w[:, cz], "w_xbc": torch.cat([w[:, cx], w[:, cbc]], 1),
            "w_dt": w[:, cdt],
            "conv_w": p["conv_w"].index_select(-1, chans),
            "conv_b": p["conv_b"].index_select(-1, chans),
            "A_log": p["A_log"][h0:h0 + n], "D": p["D"][h0:h0 + n],
            "dt_bias": p["dt_bias"][h0:h0 + n], "norm": p["norm"][rows],
            "out_proj": p["out_proj"][rows], "ln": p["ln"]}


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, di: int, eps: float,
                reduce) -> torch.Tensor:
    """``rms_norm`` over d_inner of the heads' channels ``y`` (..., c):
    their sum of squares summed by ``reduce`` over the ranks that hold
    the other heads."""
    dt = y.dtype
    yf = y.float()
    ss = reduce(torch.sum(yf * yf, dim=-1, keepdim=True))
    yf = yf * torch.rsqrt(ss / di + eps)
    return (yf * scale.float()).to(dt)


def _ssd_chunks(xs, dt, dA, Bm, Cm, Q: int, out_dtype):
    """The chunked SSD of x (B, S, nh, hp) with dt, dA (B, S, nh) and B, C
    (B, S, N): (y (B, S, nh, hp) in ``out_dtype``, final state (B, nh,
    hp, N) float32)."""
    Bsz, S, nh, hp = xs.shape
    N = Bm.shape[-1]
    nc = S // Q
    xc = xs.reshape(Bsz, nc, Q, nh, hp)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    dAc = dA.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    state = torch.zeros((Bsz, nh, hp, N), dtype=torch.float32,
                        device=xs.device)
    ys = []
    for c in range(nc):
        x_c, dt_c, dA_c, B_c, C_c = (xc[:, c], dtc[:, c], dAc[:, c],
                                     Bc[:, c], Cc[:, c])
        cum = torch.cumsum(dA_c, dim=1)                         # (B,Q,nh)
        CB = torch.einsum("bin,bjn->bij", C_c, B_c)             # (B,Q,Q)
        # the decay from j to i, 0 above the diagonal: masked before the
        # exp, whose argument there is positive and may overflow (an inf
        # masked after the exp gives the backward inf · 0 = NaN)
        L = torch.exp(torch.where(tri[None, :, :, None],
                                  cum[:, :, None, :] - cum[:, None, :, :],
                                  -torch.inf))                  # (B,Q,Q,nh)
        xf = x_c.float()
        xdt = xf * dt_c[..., None]                              # (B,Q,nh,hp)
        Yd = torch.einsum("bij,bijh,bjhp->bihp", CB, L, xdt)
        Yi = torch.einsum("bin,bhpn,bih->bihp", C_c, state, torch.exp(cum))
        decay_end = torch.exp(cum[:, -1:, :] - cum)             # (B,Q,nh)
        S_c = torch.einsum("bjh,bjhp,bjn->bhpn", decay_end * dt_c, xf, B_c)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + S_c
        ys.append((Yd + Yi).to(out_dtype))
    return torch.cat(ys, dim=1), state


def _forward_local(x, p, h0, n, reduce, conv, state, window, cfg,
                   return_state):
    """``ssm_local``'s function for a prefill or train step: this rank's
    share of the layer's output from heads h0 .. h0 + n - 1, and with
    ``return_state`` its conv window shard and its heads' state."""
    Bsz, S, d = x.shape
    di, nh, hp, N, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    lp = _local_params(p, cfg, h0, n)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xBC, dt_raw = h @ lp["w_z"], h @ lp["w_xbc"], h @ lp["w_dt"]
    xBC = _causal_conv(xBC, lp["conv_w"], lp["conv_b"])
    c = n * hp
    xs = xBC[..., :c].reshape(Bsz, S, n, hp)
    dt = _softplus(dt_raw.float() + lp["dt_bias"])
    dA = dt * -torch.exp(lp["A_log"])
    y, final = _ssd_chunks(xs, dt, dA, xBC[..., c:c + N],
                           xBC[..., c + N:], Q, x.dtype)
    y = y + (lp["D"][None, None, :, None] * xs.float()).to(x.dtype)
    y = y.reshape(Bsz, S, c) * F.silu(z)
    y = _gated_norm(y, lp["norm"], di, cfg.norm_eps, reduce)
    out = y @ lp["out_proj"]
    if not return_state:
        return out, None, None
    lo, cnt = window
    k1 = cfg.ssm_conv - 1
    tail = h[:, S - k1:] @ p["in_proj"][:, di + lo:di + lo + cnt]
    return out, tail, final


def _decode_local(x, p, h0, n, reduce, conv, state, window, cfg):
    """``ssm_local``'s function for a decode step: every conv channel of
    the one token (the window keeps this rank's shard), the state and
    output share of heads h0 .. h0 + n - 1."""
    Bsz = x.shape[0]
    di, nh, hp, N, conv_dim = _dims(cfg)
    cz, _, _, cdt = _heads_cols(cfg, h0, n)
    w = p["in_proj"]
    h = rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]
    xBC = h @ w[:, di:di + conv_dim]
    window_all = torch.cat([conv, xBC[:, None, :]], dim=1)      # (B,k,C)
    conv_out = torch.einsum("bkc,kc->bc", window_all, p["conv_w"]) \
        + p["conv_b"]
    xBC = F.silu(conv_out.float()).to(x.dtype)
    lo, cnt = window
    rows = slice(h0 * hp, (h0 + n) * hp)
    xs = xBC[:, rows].reshape(Bsz, n, hp).float()
    Bm = xBC[:, di: di + N].float()
    Cm = xBC[:, di + N:].float()
    dt = _softplus((h @ w[:, cdt]).float() + p["dt_bias"][h0:h0 + n])
    decay = torch.exp(dt * -torch.exp(p["A_log"][h0:h0 + n]))
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + p["D"][h0:h0 + n][None, :, None] * xs
    y = y.reshape(Bsz, n * hp).to(x.dtype) * F.silu(h @ w[:, cz])
    y = _gated_norm(y, p["norm"][rows], di, cfg.norm_eps, reduce)
    out = (y @ p["out_proj"][rows])[:, None, :]
    return out, window_all[:, 1:, lo:lo + cnt], state


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Chunked SSD. x: (B, S, d) -> (B, S, d).

    return_state: prefill mode — also return the SSMCache after S tokens
    (final SSD state + the raw pre-conv tail for the rolling conv window).
    A DTensor ``x`` runs on local shards (``shard_ops.ssm_local``).
    """
    if isinstance(x, DTensor):
        nh = _dims(cfg)[1]
        out, conv, state = ssm_local(
            lambda *a: _forward_local(*a, cfg, return_state), p, x, nh)
        if not return_state:
            return out
        return out, SSMCache(conv, state, torch.full(
            (), x.shape[1], dtype=torch.int32, device=x.device))
    Bsz, S, d = x.shape
    di, nh, hp, N, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)

    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split(p, h, cfg)
    conv_tail = xBC[:, S - (cfg.ssm_conv - 1):, :]
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = constrain(xBC[..., :di].reshape(Bsz, S, nh, hp),
                   "batch", None, "model", None)
    Bm = xBC[..., di: di + N]                      # (B, S, N)  (g = 1)
    Cm = xBC[..., di + N:]                         # (B, S, N)

    dt = _softplus(dt_raw.float() + p["dt_bias"])  # (B, S, nh) float32
    a = -torch.exp(p["A_log"])                      # (nh,)
    dA = dt * a                                     # (B, S, nh) ≤ 0

    # sequential loop over chunks: one (B, Q, Q, nh) decay tile live at a
    # time (memory-bounded, like the attention query chunks)
    y, state = _ssd_chunks(xs, dt, dA, Bm, Cm, Q, x.dtype)   # (B,S,nh,hp)
    y = y + (p["D"][None, None, :, None] * xs.float()).to(x.dtype)
    y = y.reshape(Bsz, S, di)

    # gated RMSNorm + out projection (gate in compute dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    if return_state:
        cache = SSMCache(conv=conv_tail, state=state,
                         pos=torch.full((), S, dtype=torch.int32,
                                        device=x.device))
        return out, cache
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> SSMCache:
    di, nh, hp, N, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, nh, hp, N), dtype=torch.float32,
                          device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def ssm_decode(p, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig):
    """One-token recurrent update. x: (B, 1, d). Returns (y, new_cache);
    the cache it was given is left as it was. A DTensor ``x`` and cache
    run on local shards (``shard_ops.ssm_local``)."""
    if isinstance(x, DTensor):
        out, conv, state = ssm_local(
            lambda *a: _decode_local(*a, cfg), p, x, _dims(cfg)[1],
            cache.conv, cache.state)
        return out, SSMCache(conv, state, cache.pos + 1)
    Bsz = x.shape[0]
    di, nh, hp, N, conv_dim = _dims(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split(p, h[:, 0], cfg)

    window = torch.cat([cache.conv, xBC[:, None, :]], dim=1)    # (B,k,C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out.float()).to(x.dtype)
    new_conv = window[:, 1:]

    xs = xBC[:, :di].reshape(Bsz, nh, hp).float()
    Bm = xBC[:, di: di + N].float()
    Cm = xBC[:, di + N:].float()
    dt = _softplus(dt_raw.float() + p["dt_bias"])               # (B, nh)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))              # (B, nh)

    state = cache.state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(Bsz, di).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = x + (y @ p["out_proj"])[:, None, :]
    return out, SSMCache(new_conv, state, cache.pos + 1)
