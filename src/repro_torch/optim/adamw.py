"""AdamW with decoupled weight decay and global-norm gradient clipping (port
of ``repro/optim/adamw.py``).

Optimizer state is a tree congruent with params (m, v in fp32). The update
is the reference's formula written out, leaf by leaf, in the reference's
order of operations — not ``torch.optim.AdamW``, which places eps and the
weight decay elsewhere and would round differently:

    g ← g · min(1, clip / max(‖g‖₂, 1e-9))        (global norm, fp32)
    m ← b1·m + (1 − b1)·g;   v ← b2·v + (1 − b2)·g²
    u = (m / bc1) / (√(v / bc2) + eps) + wd·p
    p ← (p₃₂ − lr·u) cast back to p's dtype

Every quantity stays a tensor on the params' device (the step count, the
bias corrections, the schedule's multiplier), so an update never waits for
the card.

On DTensor params (sharded training) the moments take each param's
placements, the step count is a replicated DTensor, and the global grad
norm and its clip factor are one replicated scalar on every rank: each
leaf's sum of squares is partial over its shards, and the norm is
redistributed to ``Replicate`` (an all-reduce) before it scales a grad.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


def replicated(x: torch.Tensor, like) -> torch.Tensor:
    """``x`` replicated on ``like``'s mesh when ``like`` is a DTensor (a
    DTensor ``x`` is redistributed, a plain one placed), else ``x``."""
    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    placements = [Replicate()] * mesh.ndim
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts, lists and tuples, a dict's keys
    in sorted order (the JAX package's pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, taken in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            items = [build(x) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") \
                else type(t)(items)
        return None if t is None else next(it)
    return build(like)


def _map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: Optional[Any] = None     # callable step -> lr multiplier

    def init(self, params) -> OptState:
        """Zero moments (float32, on each param's device and placements)
        and step 0 on the first leaf's device (replicated on its mesh)."""
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        first = tree_leaves(params)[0]
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        return OptState(step=replicated(step, first),
                        m=_map(zeros, params), v=_map(zeros, params))

    def update(self, grads, state: OptState, params):
        """-> (new params, new state, the global grad norm before clipping
        (0 without clipping)), as the reference's ``update``."""
        step = state.step + 1
        if self.clip_norm is not None:
            leaves = tree_leaves(grads)
            gn = replicated(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                           for g in leaves)), leaves[0])
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
            grads = _map(lambda g: g * scale, grads)
        else:
            gn = torch.zeros((), dtype=torch.float32, device=step.device)

        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return m, v, (p.float() - lr * u).to(p.dtype)

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
            tree_leaves(params))]
        new_m, new_v, new_p = (tree_unflatten(params, [o[i] for o in out])
                               for i in range(3))
        return new_p, OptState(step, new_m, new_v), gn


def cosine_schedule(warmup: int, total: int):
    """step (an int tensor) -> the lr multiplier: linear warm-up over
    ``warmup`` steps, then a cosine to 0 at ``total``; tensor arithmetic
    only, so no host sync."""
    def f(step):
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f
