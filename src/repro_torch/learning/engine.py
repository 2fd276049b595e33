"""The learning engine (port of ``repro/learning/engine.py``).

The JAX engine compiles a chunk of ``log_every`` sweeps into one call
(``lax.scan`` over sweeps, donated carries). PyTorch runs eagerly, so here
a chunk is a Python loop over sweeps, with the same contract:

  * the factors stay on their device between sweeps;
  * minibatches are drawn on the batch's device from an explicit
    ``torch.Generator`` carried in the ``LearnerState``
    (``torch.randperm(n, generator=g)[:size]``) — so for a given seed the
    draws differ from ``jax.random.choice``'s (the distribution is the
    same);
  * the log-likelihood is tracked with the factored objective
    (``objective.log_likelihood_factored``) either every sweep
    (``ll_mode="sweep"``, values read once per chunk) or once per chunk
    (``ll_mode="chunk"``);
  * step sizes come from ``schedules``, including the Armijo backtracking
    loop (one host sync per trial);
  * the host syncs with the device at each chunk's end, where metrics,
    health checks and callbacks run.

Only KrK-Picard (``"krk"``, ``"krk-stochastic"``) is ported; ``"em"`` and
``"joint"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..core.dpp import SubsetBatch
from ..core.krk_picard import _alpha_beta, compute_AC, compute_C
from . import schedules
from .objective import log_likelihood_factored

ALGORITHMS = ("krk", "krk-stochastic", "em", "joint")


def emit_sweep_metrics(tracker, *, algorithm: str, runtime: str,
                       seconds: float, sweeps: int, state: "LearnerState",
                       prev_backtracks: int, lls=(), first_sweep: int = 0
                       ) -> int:
    """Emit one chunk's ``learning.*`` metrics: chunk wall time, sweep
    counter, Armijo backtrack delta, accepted step size, and the tracked
    per-sweep log-likelihoods. Returns the new cumulative backtrack
    count."""
    bt = int(state.sched.backtracks)
    tracker.observe("learning.chunk_s", seconds, algorithm=algorithm,
                    runtime=runtime, sweeps=sweeps)
    tracker.counter("learning.sweeps", sweeps)
    tracker.counter("learning.backtracks", bt - prev_backtracks)
    tracker.gauge("learning.step_size", float(state.sched.a))
    for i, ll in enumerate(lls):
        tracker.gauge("learning.log_likelihood", float(ll),
                      sweep=first_sweep + i)
    return bt


@dataclasses.dataclass
class LearnerState:
    """Everything a fit needs to continue.

    params:    (L1, L2) factors.
    sweep:     () int32 — completed sweeps.
    generator: ``torch.Generator`` on the factors' device driving
               minibatch selection (the JAX package's PRNG key).
    sched:     schedule carry (t, last accepted a, backtrack count).
    ll:        () float32 — last tracked log-likelihood (-inf if
               untracked).
    """
    params: Tuple[torch.Tensor, ...]
    sweep: torch.Tensor
    generator: torch.Generator
    sched: schedules.ScheduleState
    ll: torch.Tensor


def select_minibatch(generator: torch.Generator, batch: SubsetBatch,
                     size: int) -> SubsetBatch:
    """Uniform without-replacement minibatch, drawn on the batch's device
    (the generator must live there)."""
    if size > batch.n:
        raise ValueError(f"cannot draw minibatches of {size} from a batch "
                         f"of {batch.n} subsets")
    sel = torch.randperm(batch.n, generator=generator,
                         device=batch.indices.device)[:size]
    return SubsetBatch(batch.indices[sel], batch.mask[sel])


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class LearningEngine:
    """Runs KronDPP learning sweeps in chunks; one instance per
    (algorithm, schedule, options) config.

    backend: the engine of the dense-Θ partial traces
        (``kernels.ops.partial_trace_A/C``): None — the CUDA kernels for
        CUDA tensors, the plain versions for CPU tensors; "reference" —
        the plain versions on any device; "cuda" — the kernels.
    """

    def __init__(self, algorithm: str = "krk",
                 schedule: Optional[schedules.Schedule] = None,
                 minibatch_size: Optional[int] = None,
                 use_dense_theta: bool = False, fresh_theta: bool = True,
                 ll_mode: str = "sweep", backend: Optional[str] = None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got {algorithm!r}")
        if ll_mode not in ("sweep", "chunk", "none"):
            raise ValueError(f"ll_mode must be sweep|chunk|none, got {ll_mode!r}")
        if schedule is None:
            schedule = schedules.constant(1.0)
        if schedule.kind == "armijo" and algorithm in ("em", "joint"):
            raise ValueError("the Armijo schedule backtracks the KrK-Picard "
                             "half-updates; use constant/inv_sqrt for "
                             f"{algorithm}")
        if algorithm == "krk-stochastic" and minibatch_size is None:
            minibatch_size = 32
        if algorithm != "krk-stochastic" and minibatch_size is not None:
            raise ValueError(
                f"minibatch_size is only consumed by krk-stochastic; "
                f"got minibatch_size={minibatch_size} with {algorithm!r} "
                "(api.fit auto-promotes krk to krk-stochastic)")
        if algorithm in ("em", "joint"):
            raise NotImplementedError(
                f"algorithm {algorithm!r} is not ported to repro_torch yet "
                f"(ROADMAP.md, queue 1 #8: EM and joint Picard)")
        self.algorithm = algorithm
        self.schedule = schedule
        self.minibatch_size = minibatch_size
        self.use_dense_theta = use_dense_theta
        self.fresh_theta = fresh_theta
        self.ll_mode = ll_mode
        self.backend = backend

    # -- objective -----------------------------------------------------------
    def _ll_value(self, params, batch) -> torch.Tensor:
        return log_likelihood_factored(tuple(params), batch)

    # -- one chunk -----------------------------------------------------------
    def _chunk(self, state: LearnerState, batch: SubsetBatch, chunk_len: int
               ) -> Tuple[LearnerState, List[torch.Tensor]]:
        """``chunk_len`` sweeps; returns the new state and the per-sweep
        tracked log-likelihoods (device tensors, not yet read)."""
        lls = []
        for _ in range(chunk_len):
            sub = (select_minibatch(state.generator, batch,
                                    self.minibatch_size)
                   if self.minibatch_size else batch)
            a_trial = schedules.trial_step(self.schedule, state.sched)
            params, a_acc, n_bt = self._krk_sweep(state.params, sub, a_trial)
            sched = schedules.advance(self.schedule, state.sched, a_acc, n_bt)
            ll = (self._ll_value(params, batch)
                  if self.ll_mode == "sweep" else state.ll)
            state = LearnerState(tuple(params), state.sweep + 1,
                                 state.generator, sched, ll)
            lls.append(ll)
        if self.ll_mode == "chunk":
            state = dataclasses.replace(
                state, ll=self._ll_value(state.params, batch))
        return state, lls

    # -- one sweep -----------------------------------------------------------
    def _krk_sweep(self, params, sub: SubsetBatch, a_trial: torch.Tensor):
        """Alg. 1 sweep, op-for-op the math of ``core.krk_picard_step`` but
        with the two half-updates exposed so a step size can be backtracked
        against each precomputed ascent direction. Returns
        (params, accepted a, backtracks)."""
        L1, L2 = params
        N1, N2 = L1.shape[0], L2.shape[0]
        armijo = self.schedule.kind == "armijo"

        A, C0 = compute_AC(L1, L2, sub, self.use_dense_theta, self.backend)
        d1, P1 = torch.linalg.eigh(L1)
        d2, P2 = torch.linalg.eigh(L2)
        alpha, beta0 = _alpha_beta(d1, d2)
        G1 = L1 @ A @ L1 - (P1 * (d1 ** 2 * alpha)[None, :]) @ P1.T

        def upd1(a):
            Ln = L1 + (a / N2) * G1
            return 0.5 * (Ln + Ln.T)

        if armijo:
            ll_ref = log_likelihood_factored((L1, L2), sub)
            L1n, ll1, a1, bt1 = schedules.armijo_halfstep(
                self.schedule, upd1,
                lambda M: log_likelihood_factored((M, L2), sub),
                ll_ref, a_trial)
        else:
            L1n, a1, bt1 = upd1(a_trial), a_trial, 0

        if self.fresh_theta:
            C = compute_C(L1n, L2, sub, self.use_dense_theta, self.backend)
            _, beta = _alpha_beta(torch.linalg.eigvalsh(L1n), d2)
        else:
            C, beta = C0, beta0
        G2 = L2 @ C @ L2 - (P2 * beta[None, :]) @ P2.T

        def upd2(a):
            Ln = L2 + (a / N1) * G2
            return 0.5 * (Ln + Ln.T)

        if armijo:
            L2n, _, a2, bt2 = schedules.armijo_halfstep(
                self.schedule, upd2,
                lambda M: log_likelihood_factored((L1n, M), sub),
                ll1, a_trial)
            return (L1n, L2n), torch.minimum(a1, a2), bt1 + bt2
        return (L1n, upd2(a_trial)), a_trial, 0

    # -- state / run loop ----------------------------------------------------
    def init_state(self, params: Sequence[torch.Tensor],
                   batch: Optional[SubsetBatch] = None, seed: int = 0,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = "cuda") -> LearnerState:
        """A fresh state on ``device``: float32 clones of ``params`` (a
        fit never changes a caller's tensors in place), a generator seeded
        with ``seed`` unless ``generator`` (which must live on ``device``)
        is given, and the initial log-likelihood on ``batch``."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        elif generator.device.type != dev.type or None not in (
                generator.device.index, dev.index) \
                and generator.device.index != dev.index:
            raise ValueError(f"generator lives on {generator.device}, the "
                             f"fit runs on {dev}")
        params = tuple(torch.as_tensor(p).to(device=dev, dtype=torch.float32,
                                             copy=True) for p in params)
        if batch is not None and self.ll_mode != "none":
            ll = self._ll_value(params, batch)
        else:
            ll = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
        return LearnerState(params, torch.zeros((), dtype=torch.int32,
                                                device=dev),
                            generator, schedules.init_state(self.schedule,
                                                            dev), ll)

    def run(self, state: LearnerState, batch: SubsetBatch, iters: int,
            log_every: int = 1,
            callback: Optional[Callable[[LearnerState], None]] = None,
            health: Optional["obs.HealthMonitor"] = None
            ) -> Tuple[LearnerState, List[float], List[int], List[float]]:
        """Drive ``iters`` sweeps as ceil(iters/log_every) chunks.

        Returns (state, lls, ll_sweeps, chunk_times): ``lls[i]`` is the
        log-likelihood after sweep ``ll_sweeps[i]`` (absolute, i.e. offset
        by any earlier progress of the state); ``chunk_times`` are
        host-clock seconds per chunk, each ending in a device sync.

        When a tracker is configured (``repro_torch.obs``), each chunk
        also emits ``learning.*`` metrics (``emit_sweep_metrics``) and a
        ``learning.chunk`` span. With the default ``NullTracker`` the loop
        is emission-free.

        health: an ``obs.HealthMonitor`` fed ``check_learning`` at every
        chunk boundary, where the host is already synced.
        """
        log_every = max(1, int(log_every))
        lls: List[float] = []
        ll_sweeps: List[int] = []
        times: List[float] = []
        start = int(state.sweep)
        done = 0
        tracker = obs.current_tracker()
        track = obs.enabled(tracker)
        need_bt = track or health is not None
        prev_bt = int(state.sched.backtracks) if need_bt else 0
        while done < iters:
            n = min(log_every, iters - done)
            t0 = time.perf_counter()
            with obs.spans.start_span("learning.chunk", tracker=tracker,
                                      sweeps=n, algorithm=self.algorithm):
                state, chunk_lls = self._chunk(state, batch, n)
                _sync(state.params[0])
            times.append(time.perf_counter() - t0)
            done += n
            chunk_track_lls: List[float] = []
            if self.ll_mode == "sweep":
                chunk_track_lls = torch.stack(chunk_lls).cpu().tolist()
                lls.extend(chunk_track_lls)
                ll_sweeps.extend(range(start + done - n + 1, start + done + 1))
            elif self.ll_mode == "chunk":
                chunk_track_lls = [float(state.ll)]
                lls.append(chunk_track_lls[0])
                ll_sweeps.append(start + done)
            bt_now = int(state.sched.backtracks) if need_bt else 0
            if track:
                emit_sweep_metrics(
                    tracker, algorithm=self.algorithm, runtime="local",
                    seconds=times[-1], sweeps=n, state=state,
                    prev_backtracks=prev_bt, lls=chunk_track_lls,
                    first_sweep=start + done - len(chunk_track_lls) + 1)
            if health is not None:
                health.check_learning(
                    state.params, self.algorithm,
                    ll=chunk_track_lls[-1] if chunk_track_lls else None,
                    backtracks=bt_now - prev_bt)
            prev_bt = bt_now
            if callback is not None:
                callback(state)
        return state, lls, ll_sweeps, times
