"""Step-size schedules for the Picard-family ascent updates (port of
``repro/learning/schedules.py``).

Three policies for the paper's step size ``a`` (Sec. 3.1.1):

  constant   a_t = a0. Thm 3.2 guarantees monotone ascent for a <= 1 as
             long as iterates stay PD; a0 > 1 often converges faster but
             forfeits the guarantee.
  inv_sqrt   a_t = a0 / sqrt(1 + t) — the classic stochastic decay for
             minibatch sweeps.
  armijo     backtracking line search per half-update: start from a trial
             step, shrink until the candidate factor is PD *and* the
             sweep-batch log-likelihood does not decrease. Because Thm 3.2
             holds at a <= 1 for PD iterates, the loop always terminates
             with an accepted step — restoring the guarantee while letting
             a_t float above 1 when the objective allows.

The schedule config is a frozen dataclass; the mutable part
(``ScheduleState``) is three 0-d tensors on the factors' device. The JAX
package runs the Armijo loop as a ``lax.while_loop`` on the device; here
it is a Python loop, and deciding whether to try again reads the trial's
verdict on the host: one host sync per trial.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .. import obs
from .._device import DeviceLike, resolve_device

# fp slack on the ascent test: accept steps that hold LL to within
# accumulation noise rather than demanding bitwise increase.
_ASCENT_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static schedule config. ``kind`` in {constant, inv_sqrt, armijo}."""
    kind: str = "constant"
    a0: float = 1.0
    shrink: float = 0.5       # armijo: backtrack factor
    grow: float = 1.3         # armijo: re-expansion after acceptance
    max_backtracks: int = 8   # armijo: trials per half-update


def constant(a0: float = 1.0) -> Schedule:
    return Schedule("constant", a0=a0)


def inv_sqrt(a0: float = 1.0) -> Schedule:
    return Schedule("inv_sqrt", a0=a0)


def armijo(a0: float = 1.5, shrink: float = 0.5, grow: float = 1.3,
           max_backtracks: int = 8) -> Schedule:
    return Schedule("armijo", a0=a0, shrink=shrink, grow=grow,
                    max_backtracks=max_backtracks)


def by_name(name: str, a0: float = 1.0) -> Schedule:
    """CLI-friendly constructor (accepts {constant, inv_sqrt, armijo})."""
    name = name.replace("-", "_")
    if name not in ("constant", "inv_sqrt", "armijo"):
        raise ValueError(f"unknown schedule {name!r}")
    return Schedule(name, a0=a0)


@dataclasses.dataclass
class ScheduleState:
    """Per-fit schedule carry: sweep counter, last accepted step, and the
    cumulative number of Armijo backtracks (diagnostics). 0-d tensors:
    float32, float32, int32."""
    t: torch.Tensor
    a: torch.Tensor
    backtracks: torch.Tensor


def init_state(sched: Schedule, device: DeviceLike = "cuda"
               ) -> ScheduleState:
    dev = resolve_device(device)
    return ScheduleState(torch.zeros((), dtype=torch.float32, device=dev),
                         torch.tensor(sched.a0, dtype=torch.float32,
                                      device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))


def trial_step(sched: Schedule, state: ScheduleState) -> torch.Tensor:
    """The step size to (try to) use on sweep t, a float32 0-d tensor."""
    a0 = torch.full((), sched.a0, dtype=torch.float32, device=state.a.device)
    if sched.kind == "constant":
        return a0
    if sched.kind == "inv_sqrt":
        return sched.a0 / torch.sqrt(1.0 + state.t)
    # armijo: re-expand from the last accepted step, capped at a0. a = 0
    # records a fully-failed sweep (all trials rejected); retry from a0
    # rather than letting 0 absorb the schedule (0 * grow == 0 forever).
    return torch.where(state.a > 0.0,
                       torch.minimum(a0, state.a * sched.grow), a0)


def advance(sched: Schedule, state: ScheduleState, accepted_a: torch.Tensor,
            n_backtracks) -> ScheduleState:
    return ScheduleState(state.t + 1.0, accepted_a.to(torch.float32),
                         state.backtracks + int(n_backtracks))


def armijo_halfstep(sched: Schedule,
                    update_fn: Callable[[torch.Tensor], torch.Tensor],
                    ll_fn: Callable[[torch.Tensor], torch.Tensor],
                    ll_ref: torch.Tensor, a_trial: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               int]:
    """One backtracked half-update.

    ``update_fn(a)`` produces the candidate factor for step size ``a``
    (the ascent direction is precomputed by the caller, so each trial is
    one AXPY + symmetrization); acceptance requires the candidate to be
    PD and ``ll_fn`` not to decrease below ``ll_ref``. A candidate that is
    not PD has a NaN log-likelihood (``core.dpp.masked_inv_and_logdet``),
    never an exception. Returns (factor, ll, a_used, n_backtracks); if
    every trial fails, the factor is left unchanged (a_used = 0), which is
    always a safe fixed point. Each trial's verdict is read on the host
    (one sync per trial).
    """
    L_orig = update_fn(torch.zeros_like(a_trial))   # == current factor

    def evaluate(a):
        cand = update_fn(a)
        lam_min = torch.linalg.eigvalsh(cand)[0]
        ll = ll_fn(cand)
        ok = (lam_min > 0.0) & (ll >= ll_ref - _ASCENT_TOL) \
            & torch.isfinite(ll)
        with obs.spans.start_span("learning.host_sync"):
            ok = bool(ok)
        return cand, ll, ok

    a = a_trial
    cand, ll, ok = evaluate(a)
    k = 0
    while not ok and k < sched.max_backtracks:
        a = a * sched.shrink
        cand, ll, ok = evaluate(a)
        k += 1
    if ok:
        return cand, ll, a, k
    return L_orig, ll_ref, torch.zeros_like(a), k
