"""Train / eval / serve step builders (port of ``repro/train/steps.py``).

The steps are eager PyTorch: gradients come from ``torch.autograd.grad``
of ``LM.loss_fn`` over the parameter leaves, where the JAX package takes
``jax.value_and_grad`` under ``jit``.

Sharded training is the same step on DTensor params, optimizer state and
batch, placed by ``repro_torch.distributed.ShardingPolicy`` (the
reference's ``jit(step, in_shardings=...)``): DTensor's sharding
propagation plays GSPMD's part. The step then runs under the params'
mesh (``distributed.constraints.use_mesh``, unless the caller set one)
and ``implicit_replication`` (the model's plain constants, rope's tables
and masks, act as replicated DTensors). Grads, each microbatch's slice
and the fp32 accumulator are pinned to the reference's layouts
(``constrain_params``, ``constrain``) at the reference's places.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from ..distributed.constraints import (constrain, constrain_params,
                                       sharded_context, splittable)
from ..distributed.sharding import distribute
from ..models import LM
from ..optim import AdamW, OptState
from ..optim.adamw import tree_leaves, tree_unflatten


def _value_and_grad(lm: LM, params, batch):
    """(loss, grads of ``params``' leaves in params' structure): the
    leaves are detached copies that require grad, so the caller's params
    are never part of a graph. Under a mesh the grads take the params'
    layout."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), constrain_params(tree_unflatten(params, grads))


def make_train_step(lm: LM, opt: AdamW, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    microbatches > 1: gradient accumulation over ``microbatches`` slices
    of the batch, one after the other (the reference's ``lax.scan``) —
    bounds live activation memory to one microbatch; the grad accumulator
    and the loss sum are fp32, and both are divided by ``microbatches``.
    """

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        with sharded_context(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(lm, params, batch)
        else:
            split = {k: splittable(torch.as_tensor(x), microbatches, 0)
                     .reshape(microbatches, x.shape[0] // microbatches,
                              *x.shape[1:])
                     for k, x in batch.items()}
            # the fp32 accumulator shards like the params
            acc = constrain_params(tree_unflatten(params, [
                torch.zeros_like(p, dtype=torch.float32)
                for p in tree_leaves(params)]))
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(acc)[0].device)
            for i in range(microbatches):
                mb = {k: constrain(x[i], "batch", *([None] * (x.dim() - 2)))
                      for k, x in split.items()}
                loss, g = _value_and_grad(lm, params, mb)
                acc = constrain_params(tree_unflatten(params, [
                    a + b.float() for a, b in zip(tree_leaves(acc),
                                                  tree_leaves(g))]))
                loss_sum = loss_sum + loss
            grads = tree_unflatten(params, [a / microbatches
                                            for a in tree_leaves(acc)])
            loss = loss_sum / microbatches
        new_params, new_opt, gnorm = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_opt.step.float()}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(lm: LM):
    def eval_step(params, batch):
        with torch.no_grad():
            return lm.loss_fn(params, batch)
    return eval_step


def make_serve_steps(lm: LM, policy=None):
    """(prefill_step, decode_step) for the serving path. With a
    ``ShardingPolicy`` (params, tokens and state placed by it) the
    outputs are placed as the reference's ``out_shardings``: the logits
    by ``logits_shardings``, the decode state by
    ``decode_state_shardings``."""

    def place(tree, shardings):
        # DTensor leaves move to their sharding; a plain leaf (a position
        # every rank computed alike) stays as it is
        if isinstance(tree, DTensor):
            return distribute(tree, shardings)
        if isinstance(tree, dict):
            return {k: place(v, shardings[k]) for k, v in tree.items()}
        if isinstance(tree, tuple):
            items = [place(v, s) for v, s in zip(tree, shardings)]
            return type(tree)(*items) if hasattr(tree, "_fields") \
                else tuple(items)
        return tree

    def placed(logits, state):
        if policy is None:
            return logits, state
        return (place(logits, policy.logits_shardings(logits.shape[0])),
                place(state, policy.decode_state_shardings(state)))

    def prefill_step(params, tokens, enc_embeds=None):
        return placed(*lm.prefill(params, tokens, enc_embeds=enc_embeds))

    def decode_step(params, token, state):
        return placed(*lm.decode_step(params, token, state))

    return prefill_step, decode_step
