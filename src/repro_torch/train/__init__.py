"""Training (port of ``repro/train``): eager train/eval steps and the
fault-tolerant ``Trainer``."""

from .steps import make_eval_step, make_serve_steps, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "make_eval_step", "make_serve_steps",
           "Trainer", "TrainerConfig"]
