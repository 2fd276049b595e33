"""Shared model components: initializers, norms, rotary embeddings (port of
``repro/models/common.py``).

Every function takes and returns tensors in the dtype the JAX function
gives: the norm, the rotary embedding and the softmax compute in float32
and cast back, as there. ``seq_map`` (a ``lax.scan``) is a Python loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as prng


def dense_init(key, shape: Sequence[int], dtype: torch.dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights of ``shape`` (..., *shape) from a key
    (..., 2): float32 normals times 1/sqrt(fan_in) formed in float32, then
    cast to ``dtype``."""
    fan_in = fan_in or shape[0]
    scale = np.float32(1.0) / np.sqrt(np.float32(fan_in))
    return (prng.normal(key, shape) * float(scale)).to(dtype)


def embed_init(key, shape: Sequence[int], dtype: torch.dtype
               ) -> torch.Tensor:
    return (prng.normal(key, shape) * float(np.float32(0.02))).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary position embedding. x: (..., S, H, Dh), positions: (..., S)
    (an integer tensor on x's device)."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(float(np.float32(theta)), exps)
    angles = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    # silu in compute dtype (bf16) — halves the FFN activation working set;
    # normalizations/softmax stay fp32.
    return F.silu(gate) * up


def seq_map(f: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``f(0) .. f(n - 1)`` stacked on a new leading axis (the JAX
    package's ``lax.scan`` over chunk indices, as a loop)."""
    return torch.stack([f(i) for i in range(n)])


def stable_softmax(scores: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """Masked softmax in fp32; fully-masked rows yield zeros (not NaN)."""
    scores = torch.where(mask, scores, -1e30)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    e = torch.where(mask, e, 0.0)
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp_min(denom, 1e-30)
