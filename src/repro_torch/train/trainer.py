"""Fault-tolerant training loop: checkpoint/auto-resume, emergency save,
straggler deadline hooks (port of ``repro/train/trainer.py``).

The loop is deliberately host-driven (one train step per iteration) — the
standard posture for large fleets where the coordinator must observe
failures between steps. A step's time is taken after the card has
finished it (``torch.cuda.synchronize``); on the CPU the step is done when
it returns. On DTensor state (sharded training) every rank runs ``fit``:
the step, its synchronize and the checkpoint calls, whose save gathers
each leaf on every rank and writes on one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointConfig, CheckpointManager
from ..models import LM
from ..optim import AdamW


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    # straggler mitigation: if a step exceeds deadline_factor * median step
    # time, record it and invoke the hook (skip data / re-dispatch on fleet).
    straggler_deadline_factor: float = 3.0


class Trainer:
    def __init__(self, lm: LM, opt: AdamW, train_step: Callable,
                 cfg: TrainerConfig,
                 straggler_hook: Optional[Callable[[int, float], None]] = None):
        self.lm = lm
        self.opt = opt
        self.train_step = train_step
        self.cfg = cfg
        self.straggler_hook = straggler_hook
        self.ckpt: Optional[CheckpointManager] = None
        if cfg.checkpoint_dir:
            self.ckpt = CheckpointManager(CheckpointConfig(
                directory=cfg.checkpoint_dir,
                keep=cfg.keep_checkpoints,
                save_interval_steps=cfg.checkpoint_every))
        self.step_times: list = []
        self.stragglers: list = []

    # -- resume ---------------------------------------------------------------
    def try_resume(self, params, opt_state):
        """Restore latest committed checkpoint if present (auto-resume);
        each leaf onto its target leaf's device."""
        if self.ckpt is None:
            return params, opt_state, 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt_state, 0
        state = self.ckpt.restore(latest, target={"params": params,
                                                  "opt": opt_state})
        return state["params"], state["opt"], latest

    # -- main loop --------------------------------------------------------------
    def fit(self, params, opt_state, batches: Iterator[Dict[str, Any]],
            start_step: int = 0) -> Dict[str, Any]:
        history = []
        step = start_step
        last_saved = -1
        dev = self.lm.device
        try:
            for batch in batches:
                if step >= self.cfg.total_steps:
                    break
                t0 = time.perf_counter()
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                self.step_times.append(dt)
                step += 1

                med = float(np.median(self.step_times[-50:]))
                if (len(self.step_times) > 5
                        and dt > self.cfg.straggler_deadline_factor * med):
                    self.stragglers.append((step, dt))
                    if self.straggler_hook:
                        self.straggler_hook(step, dt)

                if step % self.cfg.log_every == 0:
                    history.append({"step": step,
                                    "loss": float(metrics["loss"]),
                                    "grad_norm": float(metrics["grad_norm"]),
                                    "step_time_s": dt})
                if self.ckpt and self.ckpt.should_save(step):
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
                    last_saved = step
        except KeyboardInterrupt:
            if self.ckpt:
                self.ckpt.emergency_save(step, {"params": params,
                                                "opt": opt_state})
            raise
        if self.ckpt and step != last_saved:
            self.ckpt.save(step, {"params": params, "opt": opt_state},
                           blocking=True)
        if self.ckpt:
            self.ckpt.wait()
        return {"params": params, "opt_state": opt_state, "history": history,
                "stragglers": self.stragglers, "final_step": step}
