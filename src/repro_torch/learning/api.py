"""One-call learning API: ``fit(model, batch, algorithm=..., ...)`` (port of
``repro/learning/api.py``).

    import torch
    from repro_torch import dpp
    from repro_torch.learning import schedules

    rep = dpp.Kron(factors).fit(batch, algorithm="krk",
                                use_dense_theta=True,
                                schedule=schedules.armijo(a0=1.5), iters=5,
                                checkpoint_dir="ck", save_every=2)

KrK-Picard, batch (``"krk"``) and stochastic (``"krk-stochastic"``), EM
(``"em"``), joint Picard (``"joint"``) and the low-rank dual learner
(``"lowrank"``, ``lowrank.learn.fit_lowrank``), with checkpoints
(``checkpoint_dir=``, ``save_every=``, ``resume=``) in the JAX package's
layout for every learner but ``"lowrank"``, which ignores them as the JAX
package does. ``runtime=`` is the ``repro_torch.dpp.runtime`` placement:
``Local()`` (the default) runs the engine on ``device``;
``Mesh(axes={"data": n}, devices=[...])`` runs krk / krk-stochastic
through ``core.distributed.make_distributed_krk_sweep`` — Θ-statistics
and Armijo acceptance log-likelihoods summed over the data shards,
per-shard minibatches — with the engine's schedules. The pre-runtime
``mesh=`` keyword is a DeprecationWarning shim onto ``runtime=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from .. import obs
from .._device import DeviceLike, as_float, resolve_device
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..core.dpp import SubsetBatch
from ..core.krondpp import KronDPP
from . import schedules as schedules_mod
from .engine import ALGORITHMS, LearnerState, LearningEngine, host_read


@dataclasses.dataclass
class FitReport:
    """What a fit returns. ``model`` is a ``core.KronDPP`` for krk/joint
    and the dense reconstruction V diag(λ) V^T for em (``dpp.Model.fit``
    wraps it into a ``dpp.Kron`` or a ``dpp.Dense``);
    ``log_likelihoods[i]`` is the tracked LL after sweep ``ll_sweeps[i]``
    (sweep 0 = init). ``health`` is the
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


def _normalize_params(model, algorithm: str, dev: torch.device):
    """-> the engine's params on ``dev``: the two factors of a
    ``core.KronDPP``, a ``dpp.Kron`` or a factor tuple; for em, (λ, V) of
    a dense kernel (or of a KronDPP's full matrix), λ floored at 1e-6."""
    if algorithm == "em":
        L0 = model.full_matrix() if isinstance(model, KronDPP) else model
        lam, V = torch.linalg.eigh(as_float(L0, dev))
        return (torch.clamp_min(lam, 1e-6), V)
    factors = tuple(model.factors) if hasattr(model, "factors") \
        else tuple(model)
    if len(factors) != 2:
        raise ValueError(f"{algorithm} learning needs exactly 2 factors, "
                         f"got {len(factors)}")
    return factors


def _to_model(params, algorithm: str):
    if algorithm == "em":
        lam, V = params
        return (V * lam[None, :]) @ V.T
    return KronDPP(tuple(params))


def _mesh_statistics(rt, algorithm: str, use_dense_theta: bool,
                     minibatch_size: Optional[int], batch: SubsetBatch):
    """The engine's ``core.distributed.ShardedStatistics`` for a fit on the
    mesh ``rt``, after the JAX package's refusals: only the KrK-Picard
    learner, only the per-subset Θ route, a batch that divides the data
    shards, a minibatch no larger than the batch that divides them too."""
    from ..core.distributed import ShardedStatistics
    if algorithm not in ("krk", "krk-stochastic"):
        raise ValueError("the mesh runtime implements the KrK-Picard "
                         f"learner only, got {algorithm!r}")
    if use_dense_theta:
        raise ValueError("use_dense_theta is a single-device route (dense "
                         "Θ is O(N²)); the mesh runtime accumulates the "
                         "sparse per-subset statistics")
    shards = rt.num_data_shards
    if batch.n % shards:
        raise ValueError(
            f"batch of {batch.n} subsets does not divide the mesh's "
            f"{shards} data shards; trim with runtime.even_batch(batch)")
    stats = ShardedStatistics(rt, rt.data_axes)
    if minibatch_size:
        if minibatch_size > batch.n:
            raise ValueError(f"cannot draw minibatches of {minibatch_size} "
                             f"from a batch of {batch.n} subsets")
        stats.share(minibatch_size)
    return stats


def fit(model, batch: SubsetBatch, algorithm: str = "krk", iters: int = 10,
        a: float = 1.0, schedule: Optional[schedules_mod.Schedule] = None,
        minibatch_size: Optional[int] = None, seed: int = 0,
        key=None, generator: Optional[torch.Generator] = None,
        log_every: int = 1,
        track_ll: bool = True, ll_mode: Optional[str] = None,
        use_dense_theta: bool = False, fresh_theta: bool = True,
        checkpoint_dir: Optional[str] = None, save_every: Optional[int] = None,
        resume: bool = False, mesh=None, runtime=None,
        power_iters: int = 50, health=None,
        backend: Optional[str] = None,
        device: DeviceLike = "cuda") -> FitReport:
    """Fit a (Kron)DPP to a subset batch.

    algorithm: "krk" (batch Alg. 1), "krk-stochastic" (minibatch
        sweeps; a ``minibatch_size`` turns "krk" into it), "em"
        (Gillenwater et al. baseline; ``model`` a dense kernel or a
        KronDPP), "joint" (Alg. 3, no ascent guarantee) or "lowrank"
        (``model`` a ``dpp.LowRank`` or a pair (V, q); default schedule
        ``armijo(a0=a)``; see ``lowrank.learn.fit_lowrank``).
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
    checkpoint_dir/save_every/resume: persist ``LearnerState`` through
        ``repro_torch.checkpoint.CheckpointManager`` every ``save_every``
        sweeps (rounded up to chunk boundaries) and at the end, and resume
        from the latest committed state, continuing the exact key (or
        generator) and schedule stream: ``iters`` counts the resumed
        sweeps too, and ``ll_sweeps[0]`` is the first new sweep.
    power_iters: joint Picard's power-method steps.
    health: numerics sentinels (``repro_torch.obs.health``) checked at the
        start and at every chunk boundary, folded into
        ``FitReport.health``. Pass an ``obs.HealthMonitor`` (or
        ``obs.HealthThresholds``) to force it on; default None monitors
        automatically iff a tracker is configured.
    runtime: a ``repro_torch.dpp.runtime`` placement — ``Local()``
        (default) runs the engine on ``device``; ``Mesh(axes={"data": n},
        devices=[...])`` runs krk / krk-stochastic through the sharded
        sweep (``core.distributed.make_distributed_krk_sweep``):
        Θ-statistics and Armijo acceptance LLs summed over the data
        shards, per-shard minibatches from PRNG keys. The batch size must
        divide the data-shard count (``runtime.even_batch`` trims), and
        ``device`` must be the mesh's first data shard's. ``Host()`` has
        no learner (``ValueError``).
    mesh: deprecated — a ``Mesh``, shimmed onto ``runtime=`` with a
        DeprecationWarning.
    backend: the engine of the dense-Θ partial traces (``LearningEngine``).
    device: where the fit runs; the factors and the batch are moved there.
        Raises ``RuntimeError`` for "cuda" (the default) without a card.
    """
    from ..dpp import runtime as runtime_mod
    if algorithm == "lowrank":
        # the dual-space learner for LowRank(V, q) models, dispatched before
        # the engine's ALGORITHMS check (its state is (V, q), not square
        # factors) with the JAX package's kwargs: as there, checkpoint_dir,
        # save_every, resume and mesh are not passed on
        if generator is not None:
            raise ValueError("the lowrank learner draws its minibatches "
                             "from key= or seed=, not a generator")
        from ..lowrank.learn import fit_lowrank
        return fit_lowrank(model, batch, iters=iters, a=a,
                           schedule=schedule,
                           minibatch_size=minibatch_size, seed=seed,
                           key=key, log_every=log_every,
                           track_ll=track_ll, ll_mode=ll_mode,
                           runtime=runtime, health=health, device=device)
    with obs.spans.start_span("learning.setup"):
        rt = runtime_mod.resolve(runtime, mesh=mesh, stacklevel=3)
        if rt.kind == "host":
            raise ValueError("learning has no host runtime; use Local() or "
                             "Mesh(...)")
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got {algorithm!r}")
        dev = rt.home(device) if rt.is_mesh else resolve_device(device)
        if rt.is_mesh and generator is not None:
            raise ValueError("a Mesh runtime draws its minibatches from "
                             "PRNG keys (key= or seed=), not a "
                             "torch.Generator")
        if algorithm == "krk" and minibatch_size is not None:
            # a minibatch request IS stochastic
            algorithm = "krk-stochastic"
        if schedule is None:
            schedule = schedules_mod.constant(a)
        if ll_mode is None:
            ll_mode = "sweep" if track_ll else "none"

        stats = None
        if rt.is_mesh:
            stats = _mesh_statistics(rt, algorithm, use_dense_theta,
                                     minibatch_size, batch)
        engine = LearningEngine(algorithm=algorithm, schedule=schedule,
                                minibatch_size=minibatch_size,
                                use_dense_theta=use_dense_theta,
                                fresh_theta=fresh_theta, ll_mode=ll_mode,
                                power_iters=power_iters, backend=backend,
                                stats=stats)
        batch = SubsetBatch(batch.indices.to(dev), batch.mask.to(dev))
        state = engine.init_state(_normalize_params(model, algorithm, dev),
                                  batch, seed=seed, generator=generator,
                                  device=dev, key=key)

        manager = None
        if checkpoint_dir is not None:
            manager = CheckpointManager(CheckpointConfig(
                directory=checkpoint_dir,
                save_interval_steps=max(1, save_every or iters)))
            if resume and manager.latest_step() is not None:
                state = manager.restore(target=state)

        start_sweep = host_read(state.sweep, int)
        remaining = max(0, iters - start_sweep)

        if isinstance(health, obs.HealthMonitor):
            monitor = health
        elif isinstance(health, obs.HealthThresholds):
            monitor = obs.HealthMonitor(thresholds=health,
                                        component="learning")
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
                ll=host_read(state.ll) if ll_mode != "none" else None)

        lls: List[float] = []
        ll_sweeps: List[int] = []
        if ll_mode != "none" and start_sweep == 0:
            lls.append(host_read(state.ll))
            ll_sweeps.append(0)

        last_saved = start_sweep

        def checkpoint_cb(st: LearnerState):
            nonlocal last_saved
            sweep = int(st.sweep)
            if manager is not None and save_every and \
                    sweep - last_saved >= save_every:
                manager.save(sweep, st)
                last_saved = sweep

    with obs.spans.start_span("learning.fit", algorithm=algorithm,
                              runtime=rt.kind, iters=iters):
        state, run_lls, run_sweeps, times = engine.run(
            state, batch, remaining, log_every=log_every,
            callback=checkpoint_cb, health=monitor)
    lls.extend(run_lls)
    ll_sweeps.extend(run_sweeps)
    sweeps = host_read(state.sweep, int)

    if manager is not None:
        if remaining:
            manager.save(sweeps, state)
        manager.wait()

    total_t = sum(times)
    sweeps_per_sec = (remaining / total_t) if total_t > 0 else float("inf")
    health_report = monitor.report(emit=True) if monitor is not None else None
    tracker = obs.current_tracker()
    if obs.enabled(tracker):
        tracker.event(
            "learning.fit", algorithm=algorithm, runtime=rt.kind,
            sweeps=sweeps, iters=iters,
            sweeps_per_sec=sweeps_per_sec,
            log_likelihood=(lls[-1] if lls else None),
            backtracks=host_read(state.sched.backtracks, int))
    return FitReport(
        model=_to_model(state.params, algorithm), state=state,
        log_likelihoods=lls, ll_sweeps=ll_sweeps, sweep_times=times,
        sweeps=sweeps, sweeps_per_sec=sweeps_per_sec,
        health=health_report)
