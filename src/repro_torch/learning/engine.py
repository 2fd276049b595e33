"""The learning engine (port of ``repro/learning/engine.py``).

The JAX engine compiles a chunk of ``log_every`` sweeps into one call
(``lax.scan`` over sweeps, donated carries). PyTorch runs eagerly, so here
a chunk is a Python loop over sweeps, with the same contract:

  * the factors stay on their device between sweeps;
  * minibatches follow the JAX engine's key stream: the ``LearnerState``
    carries a PRNG key (``repro_torch.random``), each sweep takes
    ``key, k_sel = split(key)`` whether or not it draws a minibatch, and a
    minibatch is ``choice(k_sel, n, (size,), replace=False)`` — so a seed
    gives the JAX engine's minibatch indices on every sweep. A state
    seeded with an explicit ``torch.Generator`` draws
    ``torch.randperm(n, generator=g)[:size]`` instead;
  * the log-likelihood is tracked with the factored objective
    (``objective.log_likelihood_factored``) either every sweep
    (``ll_mode="sweep"``, values read once per chunk) or once per chunk
    (``ll_mode="chunk"``);
  * step sizes come from ``schedules``, including the Armijo backtracking
    loop (one host sync per trial);
  * the host syncs with the device at each chunk's end, where metrics,
    health checks and callbacks run;
  * a KrK sweep takes its batch, minibatches and statistics from
    ``stats``: ``LocalStatistics`` on one device, or
    ``core.distributed.ShardedStatistics`` over a ``Mesh``'s data shards
    (``fit(runtime=Mesh(...))``), so both runtimes run this one loop.

The learners are KrK-Picard (``"krk"``, ``"krk-stochastic"``), EM
(``"em"``, params (λ, V)) and joint Picard (``"joint"``); EM and joint
Picard take the trial step as it comes (no Armijo backtracking).
``LearnerState.tree_flatten`` lists a state's leaves in the JAX pytree's
order, which is how ``repro_torch.checkpoint`` saves and restores it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from .. import random as prng
from .._device import DeviceLike, resolve_device
from ..core.dpp import SubsetBatch
from ..core.em import e_step, eigvec_ascent, m_step_eigvals
from ..core.joint_picard import joint_picard_step
from ..core.krk_picard import (_alpha_beta, compute_AC, compute_C,
                               factor_eigh)
from . import schedules
from .objective import log_likelihood_eig, log_likelihood_factored

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

    params: algorithm parameters — (L1, L2) factors for krk/joint,
            (lam, V) eigendecomposition for em.
    sweep:  () int32 — completed sweeps (resume offset).
    key:    the minibatch stream: a PRNG key (2,) on the factors' device,
            split once a sweep as the JAX engine splits its key; or a
            ``torch.Generator`` there, when the fit was given one.
    sched:  schedule carry (t, last accepted a, backtrack count).
    ll:     () float32 — last tracked log-likelihood (-inf if untracked).
    """
    params: Tuple[torch.Tensor, ...]
    sweep: torch.Tensor
    key: Union[torch.Tensor, torch.Generator]
    sched: schedules.ScheduleState
    ll: torch.Tensor

    def tree_flatten(self) -> list:
        """The leaves in the JAX package's pytree order: params..., sweep,
        key, sched.t, sched.a, sched.backtracks, ll. A key leaf is its
        uint32 words (``random.key_data``), as the JAX package holds its
        key, so a checkpoint of either package holds the same files for
        the same state; a generator's leaf is its ``get_state()``."""
        key = (self.key.get_state() if isinstance(self.key, torch.Generator)
               else prng.key_data(self.key))
        return [*self.params, self.sweep, key, self.sched.t, self.sched.a,
                self.sched.backtracks, self.ll]

    @classmethod
    def tree_unflatten(cls, leaves, like: "LearnerState",
                       device: Optional[DeviceLike] = None
                       ) -> "LearnerState":
        """A state from leaves in ``tree_flatten``'s order (numpy arrays or
        tensors, e.g. a checkpoint's) on ``device``, by default ``like``'s.
        A generator key's leaf is restored into ``like.key`` with
        ``set_state``."""
        leaves = list(leaves)
        n = len(like.params)
        if len(leaves) != n + 6:
            raise ValueError(f"a LearnerState of {n} params has {n + 6} "
                             f"leaves, got {len(leaves)}")
        dev = like.sweep.device if device is None else torch.device(device)

        def tensor(x):
            return torch.as_tensor(np.asarray(x)).to(dev)

        params, (sweep, key, t, a, bt, ll) = leaves[:n], leaves[n:]
        if isinstance(like.key, torch.Generator):
            like.key.set_state(torch.as_tensor(np.asarray(key, np.uint8)))
            key = like.key
        else:
            key = prng.as_key(np.asarray(key), dev)
        return cls(tuple(tensor(p) for p in params), tensor(sweep), key,
                   schedules.ScheduleState(tensor(t), tensor(a), tensor(bt)),
                   tensor(ll))


def select_minibatch(key, batch: SubsetBatch, size: int) -> SubsetBatch:
    """Uniform without-replacement minibatch, drawn on the batch's device:
    ``choice(key, n, (size,), replace=False)`` for a PRNG key (the JAX
    engine's indices), ``randperm(n)[:size]`` for a ``torch.Generator``
    (which must live there)."""
    if size > batch.n:
        raise ValueError(f"cannot draw minibatches of {size} from a batch "
                         f"of {batch.n} subsets")
    dev = batch.indices.device
    if isinstance(key, torch.Generator):
        sel = torch.randperm(batch.n, generator=key, device=dev)[:size]
    else:
        sel = prng.choice(prng.as_key(key, dev), batch.n, (size,),
                          replace=False)
    return SubsetBatch(batch.indices[sel], batch.mask[sel])


class LocalStatistics:
    """Where a sweep's data and statistics come from on one device: the
    batch as given, minibatches from ``select_minibatch``, A and C through
    ``core.krk_picard`` (the per-subset route, or dense Θ with
    ``use_dense_theta``) and the acceptance log-likelihood of
    ``objective.log_likelihood_factored``. ``core.distributed``'s
    ``ShardedStatistics`` is the same interface over a ``Mesh``'s data
    shards."""

    runtime = "local"            #: the ``learning.*`` metrics' runtime tag

    def __init__(self, use_dense_theta: bool = False,
                 backend: Optional[str] = None):
        self.use_dense_theta = use_dense_theta
        self.backend = backend

    def place(self, batch: SubsetBatch) -> SubsetBatch:
        return batch

    def select(self, key, data: SubsetBatch, size: int) -> SubsetBatch:
        return select_minibatch(key, data, size)

    def AC(self, L1, L2, data: SubsetBatch):
        return compute_AC(L1, L2, data, self.use_dense_theta, self.backend)

    def C(self, L1, L2, data: SubsetBatch):
        return compute_C(L1, L2, data, self.use_dense_theta, self.backend)

    def ll(self, factors, data: SubsetBatch) -> torch.Tensor:
        return log_likelihood_factored(tuple(factors), data)


def krk_sweep(params, data, a_trial, schedule: schedules.Schedule, stats,
              fresh_theta: bool = True):
    """Alg. 1 sweep, op-for-op the math of ``core.krk_picard_step`` but
    with the two half-updates exposed so a step size can be backtracked
    against each precomputed ascent direction. ``stats``
    (``LocalStatistics`` or ``core.distributed.ShardedStatistics``) gives
    A/C, C and the acceptance log-likelihood on ``data``, so every shard
    of a mesh takes the one branch of the global objective. Returns
    (params, accepted a, backtracks)."""
    L1, L2 = params
    N1, N2 = L1.shape[0], L2.shape[0]
    armijo = schedule.kind == "armijo"

    A, C0 = stats.AC(L1, L2, data)
    with obs.spans.start_span("learning.factor_eigh"):
        d1, P1 = factor_eigh(L1)
        d2, P2 = factor_eigh(L2)
    alpha, beta0 = _alpha_beta(d1, d2)
    G1 = L1 @ A @ L1 - (P1 * (d1 ** 2 * alpha)[None, :]) @ P1.T

    def upd1(a):
        Ln = L1 + (a / N2) * G1
        return 0.5 * (Ln + Ln.T)

    if armijo:
        ll_ref = stats.ll((L1, L2), data)
        L1n, ll1, a1, bt1 = schedules.armijo_halfstep(
            schedule, upd1, lambda M: stats.ll((M, L2), data), ll_ref,
            a_trial)
    else:
        L1n, a1, bt1 = upd1(a_trial), a_trial, 0

    if fresh_theta:
        C = stats.C(L1n, L2, data)
        with obs.spans.start_span("learning.factor_eigh"):
            d1n = torch.linalg.eigvalsh(L1n)
        _, beta = _alpha_beta(d1n, d2)
    else:
        C, beta = C0, beta0
    G2 = L2 @ C @ L2 - (P2 * beta[None, :]) @ P2.T

    def upd2(a):
        Ln = L2 + (a / N1) * G2
        return 0.5 * (Ln + Ln.T)

    if armijo:
        L2n, _, a2, bt2 = schedules.armijo_halfstep(
            schedule, upd2, lambda M: stats.ll((L1n, M), data), ll1,
            a_trial)
        return (L1n, L2n), torch.minimum(a1, a2), bt1 + bt2
    return (L1n, upd2(a_trial)), a_trial, 0


def _sync(x: torch.Tensor) -> None:
    with obs.spans.start_span("learning.host_sync"):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)


def host_read(x: torch.Tensor, cast: Callable = float):
    """``cast(x)`` of a tensor on the device: a blocking read, inside a
    ``learning.host_sync`` span."""
    with obs.spans.start_span("learning.host_sync"):
        return cast(x)


class LearningEngine:
    """Runs KronDPP learning sweeps in chunks; one instance per
    (algorithm, schedule, options) config.

    power_iters: power-method steps of joint Picard's nearest Kronecker
        factors (``core.kron.nearest_kron_factors``).
    backend: the engine of the dense-Θ partial traces
        (``kernels.ops.partial_trace_A/C``): None — the CUDA kernels for
        CUDA tensors, the plain versions for CPU tensors; "reference" —
        the plain versions on any device; "cuda" — the kernels.
    stats: where a KrK sweep's data, minibatches and statistics come
        from; default ``LocalStatistics(use_dense_theta, backend)``, one
        device. ``core.distributed.ShardedStatistics`` runs the same
        sweeps over a ``Mesh``'s data shards.
    """

    def __init__(self, algorithm: str = "krk",
                 schedule: Optional[schedules.Schedule] = None,
                 minibatch_size: Optional[int] = None,
                 use_dense_theta: bool = False, fresh_theta: bool = True,
                 ll_mode: str = "sweep", power_iters: int = 50,
                 backend: Optional[str] = None, stats=None):
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
        self.algorithm = algorithm
        self.schedule = schedule
        self.minibatch_size = minibatch_size
        self.use_dense_theta = use_dense_theta
        self.fresh_theta = fresh_theta
        self.ll_mode = ll_mode
        self.power_iters = power_iters
        self.backend = backend
        self.stats = stats if stats is not None else LocalStatistics(
            use_dense_theta, backend)

    # -- objective -----------------------------------------------------------
    def _ll_value(self, params, batch) -> torch.Tensor:
        with obs.spans.start_span("learning.log_likelihood"):
            if self.algorithm == "em":
                return log_likelihood_eig(params[0], params[1], batch)
            return log_likelihood_factored(tuple(params), batch)

    # -- one chunk -----------------------------------------------------------
    def _chunk(self, state: LearnerState, batch: SubsetBatch, chunk_len: int,
               data=None) -> Tuple[LearnerState, List[torch.Tensor]]:
        """``chunk_len`` sweeps on ``data`` (``stats.place(batch)``, made
        here when not given); returns the new state and the per-sweep
        tracked log-likelihoods on ``batch`` (device tensors, not yet
        read)."""
        data = self.stats.place(batch) if data is None else data
        lls = []
        for _ in range(chunk_len):
            with obs.spans.start_span("learning.sweep"):
                key = state.key
                k_sel = key
                if not isinstance(key, torch.Generator):
                    key, k_sel = prng.split(key)
                sub = (self.stats.select(k_sel, data, self.minibatch_size)
                       if self.minibatch_size else data)
                a_trial = schedules.trial_step(self.schedule, state.sched)
                params, a_acc, n_bt = self._sweep(state.params, sub, a_trial)
                sched = schedules.advance(self.schedule, state.sched, a_acc,
                                          n_bt)
                ll = (self._ll_value(params, batch)
                      if self.ll_mode == "sweep" else state.ll)
                state = LearnerState(tuple(params), state.sweep + 1, key,
                                     sched, ll)
            lls.append(ll)
        if self.ll_mode == "chunk":
            state = dataclasses.replace(
                state, ll=self._ll_value(state.params, batch))
        return state, lls

    # -- one sweep -----------------------------------------------------------
    def _sweep(self, params, sub: SubsetBatch, a_trial: torch.Tensor):
        """One sweep of the engine's algorithm. Returns (params, accepted
        a, backtracks)."""
        if self.algorithm == "em":
            lam, V = params
            q = e_step(lam, V, sub)
            lam = m_step_eigvals(q)
            V = eigvec_ascent(lam, V, sub, a_trial)
            return (lam, V), a_trial, 0
        if self.algorithm == "joint":
            L1, L2 = params
            L1, L2 = joint_picard_step(L1, L2, sub, a_trial, self.power_iters)
            return (L1, L2), a_trial, 0
        return self._krk_sweep(params, sub, a_trial)

    def _krk_sweep(self, params, sub, a_trial: torch.Tensor):
        """Alg. 1 sweep on this engine's statistics (``krk_sweep``).
        Returns (params, accepted a, backtracks)."""
        return krk_sweep(params, sub, a_trial, self.schedule, self.stats,
                         self.fresh_theta)

    # -- state / run loop ----------------------------------------------------
    def init_state(self, params: Sequence[torch.Tensor],
                   batch: Optional[SubsetBatch] = None, seed: int = 0,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = "cuda", key=None) -> LearnerState:
        """A fresh state on ``device``: float32 clones of ``params`` (a
        fit never changes a caller's tensors in place), the minibatch
        stream — ``key`` (a PRNG key, copied to ``device``), else
        ``PRNGKey(seed)`` as the JAX engine seeds it, or ``generator``
        (which must live on ``device``) when given — and the initial
        log-likelihood on ``batch``."""
        dev = resolve_device(device)
        if generator is not None and key is not None:
            raise ValueError("pass a key or a generator, not both")
        if generator is not None:
            if generator.device.type != dev.type or None not in (
                    generator.device.index, dev.index) \
                    and generator.device.index != dev.index:
                raise ValueError(f"generator lives on {generator.device}, "
                                 f"the fit runs on {dev}")
            key = generator
        elif key is None:
            key = prng.PRNGKey(seed, dev)
        else:
            key = prng.as_key(key, dev).clone()
        params = tuple(torch.as_tensor(p).to(device=dev, dtype=torch.float32,
                                             copy=True) for p in params)
        if batch is not None and self.ll_mode != "none":
            ll = self._ll_value(params, batch)
        else:
            ll = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
        return LearnerState(params, torch.zeros((), dtype=torch.int32,
                                                device=dev),
                            key, schedules.init_state(self.schedule, dev),
                            ll)

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
        start = host_read(state.sweep, int)
        done = 0
        tracker = obs.current_tracker()
        track = obs.enabled(tracker)
        need_bt = track or health is not None
        prev_bt = host_read(state.sched.backtracks, int) if need_bt else 0
        data = self.stats.place(batch)
        while done < iters:
            n = min(log_every, iters - done)
            t0 = time.perf_counter()
            with obs.spans.start_span("learning.chunk", tracker=tracker,
                                      sweeps=n, algorithm=self.algorithm):
                state, chunk_lls = self._chunk(state, batch, n, data)
                _sync(state.params[0])
            times.append(time.perf_counter() - t0)
            done += n
            chunk_track_lls: List[float] = []
            if self.ll_mode == "sweep":
                chunk_track_lls = host_read(torch.stack(chunk_lls),
                                            torch.Tensor.tolist)
                lls.extend(chunk_track_lls)
                ll_sweeps.extend(range(start + done - n + 1, start + done + 1))
            elif self.ll_mode == "chunk":
                chunk_track_lls = [host_read(state.ll)]
                lls.append(chunk_track_lls[0])
                ll_sweeps.append(start + done)
            bt_now = host_read(state.sched.backtracks, int) if need_bt else 0
            if track:
                emit_sweep_metrics(
                    tracker, algorithm=self.algorithm,
                    runtime=self.stats.runtime,
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
