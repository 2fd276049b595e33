"""Dual-space maximum-likelihood learning for ``LowRank(V, q)`` (port of
``repro/lowrank/learn.py``).

``fit(batch, algorithm="lowrank")`` lands here. One sweep is:

1. **q Picard step** — the fixed-point update of Mariet & Sra's Picard
   iteration restricted to the quality scores: ∂φ/∂log q_i = p̂_i − K_ii
   (empirical inclusion frequency minus model singleton marginal), giving
   q_i ← q_i · ((p̂_i + ε)/(K_ii + ε))^a, with K_ii = [φ(C+I)⁻¹φᵀ]_ii off
   one r×r Cholesky solve.
2. **projected-gradient V step** — ascend ∇_V of the exact low-rank
   objective φ = mean log det(φ_Y φ_Yᵀ) − log det(I_r + C)
   (``torch.autograd`` in place of ``jax.value_and_grad``), then fold each
   row's norm into q, which leaves φφᵀ unchanged and keeps the
   basis/quality split identified.

Both half-updates share one step scale: under an Armijo schedule the whole
sweep is backtracked against the pre-sweep likelihood (a = 0 is a fixed
point), one host sync per trial as in ``learning/schedules.py``. With
``item_features=`` the scores become q = softplus(X·w + b) and the sweep is
a joint gradient step on (V, w, b) with the same Armijo guard.

Everything is O(N r² + n k² r) per sweep. Minibatches come from the key
(``key, k_sel = split(key)`` every sweep, ``choice(k_sel, n, (size,),
replace=False)``), so a seed gives the JAX package's rows. Spans
(``learning.fit`` / ``learning.chunk``), ``learning.*`` metrics and
``HealthMonitor`` verdicts (the r dual eigenvalues as the "em"
parameterization's spectrum) are those of the engine learners.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Tuple

import torch

from .. import obs
from .. import random as prng
from .._device import DeviceLike, as_float, resolve_device
from ..core.dpp import SubsetBatch
from ..learning import schedules as schedules_mod
from ..learning.engine import (LearnerState, emit_sweep_metrics,
                               select_minibatch)
from ..learning.schedules import _ASCENT_TOL

_EPS = 1e-3      # Picard ratio smoothing
_RIDGE = 1e-6    # subset-Gram jitter: keeps ∇ log det finite near rank edge


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _phi(V: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return V * torch.sqrt(torch.clamp_min(q, 0.0))[:, None]


def _log_likelihood(V, q, indices, mask) -> torch.Tensor:
    """Mean log P(Y) of the padded batch under L = V diag(q) Vᵀ, via the
    dual: per-subset |Y|×|Y| Grams of feature rows (ridged so gradients
    stay finite at the rank boundary) and the r×r normalizer
    det(I_r + C)."""
    phi = _phi(V, q)
    C = phi.T @ phi
    eye_r = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
    P = phi[indices]                                   # (n, k, r)
    eye_k = torch.eye(P.shape[1], dtype=P.dtype, device=P.device)
    S = P @ P.transpose(1, 2) + _RIDGE * eye_k
    m2 = mask[:, :, None] & mask[:, None, :]
    lds = torch.linalg.slogdet(torch.where(m2, S, eye_k))[1]
    return lds.mean() - torch.linalg.slogdet(eye_r + C)[1]


def _marginal_diag(V, q) -> torch.Tensor:
    """K_ii = [φ(C+I)⁻¹φᵀ]_ii — one r×r Cholesky solve, O(Nr²)."""
    phi = _phi(V, q)
    C = phi.T @ phi
    eye_r = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
    chol = torch.linalg.cholesky(C + eye_r)
    X = torch.cholesky_solve(phi.T, chol)              # (C+I)⁻¹ φᵀ
    return torch.sum(phi * X.T, dim=1)


def _value_and_grad(fn: Callable, params: Tuple[torch.Tensor, ...]):
    """(fn(params), ∇fn(params)), the value detached."""
    leaves = tuple(p.detach().requires_grad_(True) for p in params)
    with torch.enable_grad():
        value = fn(leaves)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), grads


def _backtrack(sched: schedules_mod.Schedule, update_fn, ll_fn,
               ll_ref: torch.Tensor, a_trial: torch.Tensor):
    """Armijo halving on the whole-sweep update — ``armijo_halfstep``'s loop
    without the square-factor PD check (V is N×r; the kernel φφᵀ is PSD by
    construction). One host sync per trial. Returns (params, ll, a_used,
    n_backtracks); if every trial fails the input is kept (a_used = 0)."""
    params0 = update_fn(torch.zeros_like(a_trial))

    def evaluate(a):
        cand = update_fn(a)
        ll = ll_fn(cand)
        ok = (ll >= ll_ref - _ASCENT_TOL) & torch.isfinite(ll)
        return cand, ll, bool(ok)

    a = a_trial
    cand, ll, ok = evaluate(a)
    k = 0
    while not ok and k < sched.max_backtracks:
        a = a * sched.shrink
        cand, ll, ok = evaluate(a)
        k += 1
    if ok:
        return cand, ll, a, k
    return params0, ll_ref, torch.zeros_like(a), k


def _sweep_picard(V, q, indices, mask, p_hat, a_t, sched, use_armijo,
                  v_step: float):
    """One (q-Picard, V-gradient) sweep: (V, q, ll, a_used, n_bt). The V
    direction and K_ii are taken once at the pre-sweep point; ``update(a)``
    scales both half-updates, so a = 0 gives the input back."""
    Kd = _marginal_diag(V, q)
    ll_ref, (g,) = _value_and_grad(
        lambda p: _log_likelihood(p[0], q, indices, mask), (V,))

    def update(a):
        aq = torch.clamp_max(a, 1.0)
        q1 = q * ((p_hat + _EPS) / (Kd + _EPS)) ** aq
        V1 = V + (a * v_step) * g
        return V1, q1

    if use_armijo:
        (V1, q1), ll, a_used, n_bt = _backtrack(
            sched, update,
            lambda p: _log_likelihood(p[0], p[1], indices, mask),
            ll_ref, a_t)
    else:
        V1, q1 = update(a_t)
        ll = _log_likelihood(V1, q1, indices, mask)
        a_used, n_bt = a_t, 0
    # projection: fold row norms into q — φφᵀ is unchanged, the (basis,
    # quality) split stays identified
    n2 = torch.sum(V1 * V1, dim=1)
    q2 = q1 * n2
    V2 = V1 * torch.rsqrt(torch.clamp_min(n2, 1e-20))[:, None]
    return V2, q2, ll, a_used, n_bt


def _sweep_features(V, w, b, X, indices, mask, a_t, sched, use_armijo,
                    v_step: float):
    """One joint gradient sweep on (V, w, b) with q = softplus(X·w + b):
    (V, w, b, ll, a_used, n_bt)."""
    def ll_of(params):
        Vv, wv, bv = params
        return _log_likelihood(Vv, _softplus(X @ wv + bv), indices, mask)

    ll_ref, g = _value_and_grad(ll_of, (V, w, b))

    def update(a):
        return (V + (a * v_step) * g[0], w + a * g[1], b + a * g[2])

    if use_armijo:
        (V1, w1, b1), ll, a_used, n_bt = _backtrack(
            sched, update, ll_of, ll_ref, a_t)
    else:
        V1, w1, b1 = update(a_t)
        ll = ll_of((V1, w1, b1))
        a_used, n_bt = a_t, 0
    return V1, w1, b1, ll, a_used, n_bt


def _empirical_inclusion(batch: SubsetBatch, n_items: int) -> torch.Tensor:
    """p̂_i = fraction of observed subsets containing item i (float64)."""
    idx = batch.indices.to(torch.int64)[batch.mask]
    counts = torch.bincount(idx, minlength=n_items).to(torch.float64)
    return counts / max(1, int(batch.indices.shape[0]))


def fit_lowrank(model, batch: SubsetBatch, iters: int = 10, a: float = 1.0,
                schedule: Optional[schedules_mod.Schedule] = None,
                minibatch_size: Optional[int] = None, seed: int = 0,
                key=None, log_every: int = 1, track_ll: bool = True,
                ll_mode: Optional[str] = None, runtime=None, health=None,
                item_features=None, v_step: float = 0.1,
                device: DeviceLike = "cuda"):
    """Fit ``LowRank(V, q)`` (or, with ``item_features=``, the feature map
    q = softplus(X·w + b)) to a subset batch on ``device`` (default
    "cuda"; V, q and the batch are moved there). Called through
    ``repro_torch.learning.fit(..., algorithm="lowrank")``; the update is
    in the module docstring, the report/metrics/health contract the engine
    learners'. ``model`` is a ``LowRank`` or a pair (V (N, r), q (N,)).

    schedule: default ``armijo(a0=a)``. key / seed: the minibatch stream, a
    PRNG key (``repro_torch.random``, or the JAX package's uint32 key),
    else ``PRNGKey(seed)``. ``runtime``: ``Local()`` (or None) only; any
    other placement raises ``ValueError``, as the JAX learner refuses it."""
    from ..dpp import runtime as runtime_mod
    from ..learning.api import FitReport
    from .model import LowRank

    rt = runtime_mod.resolve(runtime)
    if rt.kind != "local":
        raise ValueError(
            "the lowrank learner runs on the Local runtime (its updates "
            "are O(Nr²); item-axis sharding is an open ROADMAP item), "
            f"got {rt.kind!r}")
    dev = resolve_device(device)
    if isinstance(model, LowRank):
        V, q = model.V, model.q
    else:
        V, q = model
    V = as_float(V, dev)
    q = as_float(q, dev)
    N = int(V.shape[0])
    if V.dim() != 2 or tuple(q.shape) != (N,):
        raise ValueError(
            f"the lowrank learner fits a LowRank model or a pair (V (N, r), "
            f"q (N,)); got shapes {tuple(V.shape)} and {tuple(q.shape)} — a "
            f"Dense/Kron kernel learns with 'krk', 'em' or 'joint'")
    if schedule is None:
        schedule = schedules_mod.armijo(a0=a)
    use_armijo = schedule.kind == "armijo"
    if ll_mode is None:
        ll_mode = "sweep" if track_ll else "none"
    if minibatch_size is not None and minibatch_size > batch.n:
        raise ValueError(
            f"cannot draw minibatches of {minibatch_size} from a batch "
            f"of {batch.n} subsets")
    key = prng.PRNGKey(seed, dev) if key is None else prng.as_key(key, dev)

    X = None
    if item_features is not None:
        X = as_float(item_features, dev)
        if X.shape[0] != N:
            raise ValueError(
                f"item_features must have {N} rows to match V, got "
                f"{tuple(X.shape)}")
        w = torch.zeros((X.shape[1],), dtype=V.dtype, device=dev)
        # init b so softplus(b) reproduces the incoming q on average — the
        # feature map starts at (roughly) the current kernel
        b = torch.tensor(math.log(math.expm1(max(float(q.mean()), 1e-6))),
                         dtype=V.dtype, device=dev)

    def scores():
        return q if X is None else _softplus(X @ w + b)

    full = SubsetBatch(batch.indices.to(device=dev, dtype=torch.int64),
                       batch.mask.to(dev))
    p_hat = _empirical_inclusion(full, N).to(V.dtype)
    sched = schedules_mod.init_state(schedule, dev)
    ll0 = float(_log_likelihood(V, scores(), full.indices, full.mask))

    def current_params():
        return (V, q) if X is None else (V, w, b)

    def dual_eigs():
        phi = _phi(V, scores())
        return torch.clamp_min(torch.linalg.eigvalsh(phi.T @ phi), 0.0)

    if isinstance(health, obs.HealthMonitor):
        monitor = health
    elif isinstance(health, obs.HealthThresholds):
        monitor = obs.HealthMonitor(thresholds=health, component="learning")
    elif health is None and obs.enabled(obs.current_tracker()):
        monitor = obs.HealthMonitor(component="learning")
    else:
        monitor = None
    if monitor is not None:
        # the r dual eigenvalues are the kernel's nonzero spectrum, so they
        # feed the PSD-margin/condition sentinels directly (the "em"
        # parameterization of check_learning)
        monitor.check_learning((dual_eigs(),), "em",
                               ll=ll0 if ll_mode != "none" else None)

    lls: List[float] = []
    ll_sweeps: List[int] = []
    if ll_mode != "none":
        lls.append(ll0)
        ll_sweeps.append(0)

    state = LearnerState(params=current_params(),
                         sweep=torch.zeros((), dtype=torch.int32, device=dev),
                         key=key, sched=sched,
                         ll=torch.tensor(ll0, dtype=torch.float32,
                                         device=dev))
    times: List[float] = []
    tracker = obs.current_tracker()
    track = obs.enabled(tracker)
    prev_bt = 0
    done = 0
    with obs.spans.start_span("learning.fit", algorithm="lowrank",
                              runtime="local", iters=iters):
        while done < iters:
            n = min(max(1, log_every), iters - done)
            chunk_lls = []
            t0 = time.perf_counter()
            with obs.spans.start_span("learning.chunk", tracker=tracker,
                                      sweeps=n, algorithm="lowrank"):
                for _ in range(n):
                    pair = prng.split(key)
                    key, k_sel = pair[0], pair[1]
                    sub = full if minibatch_size is None else \
                        select_minibatch(k_sel, full, minibatch_size)
                    a_t = schedules_mod.trial_step(schedule, sched)
                    if X is None:
                        V, q, ll, a_used, n_bt = _sweep_picard(
                            V, q, sub.indices, sub.mask, p_hat, a_t,
                            schedule, use_armijo, float(v_step))
                    else:
                        V, w, b, ll, a_used, n_bt = _sweep_features(
                            V, w, b, X, sub.indices, sub.mask, a_t,
                            schedule, use_armijo, float(v_step))
                    sched = schedules_mod.advance(schedule, sched, a_used,
                                                  n_bt)
                    if ll_mode == "sweep":
                        chunk_lls.append(ll)
                if V.is_cuda:
                    torch.cuda.synchronize(V.device)
            times.append(time.perf_counter() - t0)
            done += n
            if ll_mode == "sweep":
                lls.extend(float(x) for x in chunk_lls)
                ll_sweeps.extend(range(done - n + 1, done + 1))
                last_ll = chunk_lls[-1].to(torch.float32)
            elif ll_mode == "chunk":
                last_ll = _log_likelihood(V, scores(), full.indices,
                                          full.mask)
                lls.append(float(last_ll))
                ll_sweeps.append(done)
            else:
                last_ll = state.ll
            state = LearnerState(params=current_params(),
                                 sweep=state.sweep + n, key=key,
                                 sched=sched, ll=last_ll)
            bt_now = int(state.sched.backtracks)
            new_lls = lls[len(lls) - n:] if ll_mode == "sweep" \
                else lls[-1:] if ll_mode == "chunk" else []
            if track:
                emit_sweep_metrics(
                    tracker, algorithm="lowrank", runtime="local",
                    seconds=times[-1], sweeps=n, state=state,
                    prev_backtracks=prev_bt, lls=new_lls,
                    first_sweep=done - len(new_lls) + 1)
            if monitor is not None:
                monitor.check_learning(
                    (dual_eigs(),), "em",
                    ll=new_lls[-1] if new_lls else None,
                    backtracks=bt_now - prev_bt)
            prev_bt = bt_now

    total_t = sum(times)
    sweeps_per_sec = (iters / total_t) if total_t > 0 else float("inf")
    health_report = monitor.report(emit=True) if monitor is not None \
        else None
    if track:
        tracker.event(
            "learning.fit", algorithm="lowrank", runtime="local",
            sweeps=int(state.sweep), iters=iters,
            sweeps_per_sec=sweeps_per_sec,
            log_likelihood=(lls[-1] if lls else None),
            backtracks=int(state.sched.backtracks))
    return FitReport(
        model=LowRank(V, scores(), device=dev), state=state,
        log_likelihoods=lls, ll_sweeps=ll_sweeps, sweep_times=times,
        sweeps=int(state.sweep), sweeps_per_sec=sweeps_per_sec,
        health=health_report)
