"""Optimizers (port of ``repro/optim``): AdamW and its cosine schedule.

Not ported yet: ``compression.int8_allreduce_grads``, the int8 gradient
all-reduce. It needs a mesh's all-reduce (a ``psum`` over the data axis),
which comes with the process-group ``Mesh`` (ROADMAP.md, queue 1 #8.4).
"""

from .adamw import AdamW, OptState, cosine_schedule

__all__ = ["AdamW", "OptState", "cosine_schedule"]
