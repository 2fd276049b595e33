"""One-call learning API: ``fit(model, batch, algorithm=..., ...)`` (port of
``repro/learning/api.py``).

    import torch
    from repro_torch import dpp
    from repro_torch.learning import schedules

    rep = dpp.Kron(factors).fit(batch, algorithm="krk",
                                use_dense_theta=True,
                                schedule=schedules.armijo(a0=1.5), iters=5)

Ported: KrK-Picard, batch (``"krk"``) and stochastic
(``"krk-stochastic"``), on one device (the JAX package's ``Local``
placement). Not ported yet, each raising ``NotImplementedError`` that
names its ROADMAP.md item: ``"em"``, ``"joint"`` and ``"lowrank"``;
``runtime=``/``mesh=`` placements; ``checkpoint_dir=``/``resume=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..core.dpp import SubsetBatch
from ..core.krondpp import KronDPP
from . import schedules as schedules_mod
from .engine import ALGORITHMS, LearnerState, LearningEngine


@dataclasses.dataclass
class FitReport:
    """What a fit returns. ``model`` is a ``core.KronDPP`` (``dpp.Kron.fit``
    wraps it into a ``dpp.Kron``); ``log_likelihoods[i]`` is the tracked
    LL after sweep ``ll_sweeps[i]`` (sweep 0 = init). ``health`` is the
    final ``HealthMonitor.report()`` dict when health monitoring was on —
    automatic whenever a tracker is configured — else None."""
    model: Any
    state: LearnerState
    log_likelihoods: List[float]
    ll_sweeps: List[int]
    sweep_times: List[float]
    sweeps: int
    sweeps_per_sec: float
    health: Optional[dict] = None


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1: "
        f"{item})")


def _factors(model, algorithm: str):
    """-> the two factors of a ``core.KronDPP``, a ``dpp.Kron`` or a
    factor tuple."""
    factors = tuple(model.factors) if hasattr(model, "factors") \
        else tuple(model)
    if len(factors) != 2:
        raise ValueError(f"{algorithm} learning needs exactly 2 factors, "
                         f"got {len(factors)}")
    return factors


def fit(model, batch: SubsetBatch, algorithm: str = "krk", iters: int = 10,
        a: float = 1.0, schedule: Optional[schedules_mod.Schedule] = None,
        minibatch_size: Optional[int] = None, seed: int = 0,
        key=None, generator: Optional[torch.Generator] = None,
        log_every: int = 1,
        track_ll: bool = True, ll_mode: Optional[str] = None,
        use_dense_theta: bool = False, fresh_theta: bool = True,
        checkpoint_dir: Optional[str] = None, resume: bool = False,
        mesh=None, runtime=None, health=None,
        backend: Optional[str] = None,
        device: DeviceLike = "cuda") -> FitReport:
    """Fit a KronDPP to a subset batch.

    algorithm: "krk" (batch Alg. 1) or "krk-stochastic" (minibatch
        sweeps); a ``minibatch_size`` turns "krk" into "krk-stochastic".
    schedule: a ``schedules.Schedule``; default ``constant(a)``.
    seed / key / generator: the minibatch stream — the PRNG key ``key``
        (``repro_torch.random``, or the JAX package's uint32 key), else
        ``PRNGKey(seed)``: the JAX engine's minibatches for the same seed
        or key; or a ``torch.Generator`` on ``device`` (``randperm``
        minibatches).
    log_every: sweeps per chunk — LL/metrics reach the host once per
        chunk. ll_mode overrides how LL is tracked: "sweep" (every sweep,
        read per chunk), "chunk" (computed once per chunk), or "none";
        defaults to "sweep"/"none" per ``track_ll``.
    use_dense_theta / fresh_theta: the Θ route and the block-CCCP
        refresh, as in ``core.krk_picard_step``.
    health: numerics sentinels (``repro_torch.obs.health``) checked at the
        start and at every chunk boundary, folded into
        ``FitReport.health``. Pass an ``obs.HealthMonitor`` (or
        ``obs.HealthThresholds``) to force it on; default None monitors
        automatically iff a tracker is configured.
    backend: the engine of the dense-Θ partial traces (``LearningEngine``).
    device: where the fit runs; the factors and the batch are moved there.
        Raises ``RuntimeError`` for "cuda" (the default) without a card.
    """
    if algorithm == "lowrank":
        _not_ported("fit(algorithm='lowrank')", "lowrank/")
    if mesh is not None or runtime is not None:
        _not_ported("fit(runtime=/mesh=): placements other than one device",
                    "Placement")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                         f"got {algorithm!r}")
    if checkpoint_dir is not None or resume:
        _not_ported("fit(checkpoint_dir=/resume=)",
                    "The rest of learning, checkpoint/manager.py")
    dev = resolve_device(device)
    if algorithm == "krk" and minibatch_size is not None:
        algorithm = "krk-stochastic"   # a minibatch request IS stochastic
    if schedule is None:
        schedule = schedules_mod.constant(a)
    if ll_mode is None:
        ll_mode = "sweep" if track_ll else "none"

    engine = LearningEngine(algorithm=algorithm, schedule=schedule,
                            minibatch_size=minibatch_size,
                            use_dense_theta=use_dense_theta,
                            fresh_theta=fresh_theta, ll_mode=ll_mode,
                            backend=backend)
    batch = SubsetBatch(batch.indices.to(dev), batch.mask.to(dev))
    state = engine.init_state(_factors(model, algorithm), batch, seed=seed,
                              generator=generator, device=dev, key=key)

    if isinstance(health, obs.HealthMonitor):
        monitor = health
    elif isinstance(health, obs.HealthThresholds):
        monitor = obs.HealthMonitor(thresholds=health, component="learning")
    elif health is None and obs.enabled(obs.current_tracker()):
        monitor = obs.HealthMonitor(component="learning")
    else:
        monitor = None
    if monitor is not None:
        # checked on the INITIAL params too, so a rank-deficient or
        # ill-conditioned starting kernel is flagged even when the
        # updates immediately move away from it
        monitor.check_learning(
            state.params, algorithm,
            ll=float(state.ll) if ll_mode != "none" else None)

    lls: List[float] = []
    ll_sweeps: List[int] = []
    if ll_mode != "none":
        lls.append(float(state.ll))
        ll_sweeps.append(0)

    with obs.spans.start_span("learning.fit", algorithm=algorithm,
                              runtime="local", iters=iters):
        state, run_lls, run_sweeps, times = engine.run(
            state, batch, iters, log_every=log_every, health=monitor)
    lls.extend(run_lls)
    ll_sweeps.extend(run_sweeps)

    total_t = sum(times)
    sweeps_per_sec = (iters / total_t) if total_t > 0 else float("inf")
    health_report = monitor.report(emit=True) if monitor is not None else None
    tracker = obs.current_tracker()
    if obs.enabled(tracker):
        tracker.event(
            "learning.fit", algorithm=algorithm, runtime="local",
            sweeps=int(state.sweep), iters=iters,
            sweeps_per_sec=sweeps_per_sec,
            log_likelihood=(lls[-1] if lls else None),
            backtracks=int(state.sched.backtracks))
    return FitReport(
        model=KronDPP(tuple(state.params)), state=state,
        log_likelihoods=lls, ll_sweeps=ll_sweeps, sweep_times=times,
        sweeps=int(state.sweep), sweeps_per_sec=sweeps_per_sec,
        health=health_report)
