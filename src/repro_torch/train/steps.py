"""Train / eval / serve step builders (port of ``repro/train/steps.py``).

The steps are eager PyTorch: gradients come from ``torch.autograd.grad``
of ``LM.loss_fn`` over the parameter leaves, where the JAX package takes
``jax.value_and_grad`` under ``jit``. The reference's GSPMD hints
(``constrain``, ``constrain_params``) have no counterpart on one card;
they come with the process-group ``Mesh`` (ROADMAP.md, queue 1 #8.4).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import LM
from ..optim import AdamW, OptState
from ..optim.adamw import tree_leaves, tree_unflatten


def _value_and_grad(lm: LM, params, batch):
    """(loss, grads of ``params``' leaves in params' structure): the
    leaves are detached copies that require grad, so the caller's params
    are never part of a graph."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(lm: LM, opt: AdamW, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    microbatches > 1: gradient accumulation over ``microbatches`` slices
    of the batch, one after the other (the reference's ``lax.scan``) —
    bounds live activation memory to one microbatch; the grad accumulator
    and the loss sum are fp32, and both are divided by ``microbatches``.
    """

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        if microbatches == 1:
            loss, grads = _value_and_grad(lm, params, batch)
        else:
            split = {k: torch.as_tensor(x).reshape(
                microbatches, x.shape[0] // microbatches, *x.shape[1:])
                for k, x in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=acc[0].device)
            for i in range(microbatches):
                loss, g = _value_and_grad(
                    lm, params, {k: x[i] for k, x in split.items()})
                acc = [a + b.float() for a, b in zip(acc, tree_leaves(g))]
                loss_sum = loss_sum + loss
            grads = tree_unflatten(params, [a / microbatches for a in acc])
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


def make_serve_steps(lm: LM):
    """(prefill_step, decode_step) for the serving path."""

    def prefill_step(params, tokens):
        return lm.prefill(params, tokens)

    def decode_step(params, token, state):
        return lm.decode_step(params, token, state)

    return prefill_step, decode_step
