"""Optimizers (port of ``repro/optim``): AdamW and its cosine schedule,
and the int8 gradient all-reduce with error feedback
(``compression.int8_allreduce_grads`` over a ``DeviceMesh``'s data
group)."""

from .adamw import AdamW, OptState, cosine_schedule
from .compression import int8_allreduce_grads

__all__ = ["AdamW", "OptState", "cosine_schedule", "int8_allreduce_grads"]
