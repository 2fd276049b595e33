"""Numerics health sentinels: cheap host-side checks at sync points.

The KrK-Picard iteration (paper Thm 3.2) guarantees ascent and PSD
iterates only while its preconditions hold; in practice a fit degrades
through recognizable symptoms long before it produces garbage — a factor
eigenvalue grazing zero, a blowing-up condition number, Armijo rejecting
every trial step, a log-likelihood going nonfinite. On the sampling
side, the dual-tree/sequential sampler telegraphs trouble as residual-
mass collapse (phase-2 runs out of probability mass early) and
truncation streaks.

``HealthMonitor`` computes these sentinels where the host is ALREADY
synced — the learning chunk boundary (after ``block_until_ready``) and
the service flush scatter — so the checks cost a few small ``eigvalsh``
calls on host copies and never add a device round-trip. Each check
emits ``health.*`` gauges through the tracker seam, and the monitor
folds them into a three-state verdict:

  * ``healthy``  — nothing tripped;
  * ``degraded`` — soft thresholds crossed (PSD margin thin, condition
    number high, backtrack/truncation streaks, collapse rate);
  * ``failing``  — correctness is gone: nonfinite log-likelihood or a
    genuinely indefinite factor.

``report()`` emits a single ``health.report`` event summarizing the
verdict and every triggering gauge; ``FitReport.health`` and
``ServiceStats.health`` surface the same dict/verdict in-process.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from .tracker import Tracker, current_tracker, enabled


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Trip levels for the sentinel gauges. All soft limits mark the
    monitor ``degraded``; the two hard conditions (nonfinite LL,
    indefinite factor) mark it ``failing``."""
    #: minimum relative PSD margin λmin/λmax per factor before "degraded"
    #: (1e-6 ≈ 8·float32-eps: below this a factor is numerically singular
    #: for the float32 inverses the sweeps take)
    min_psd_margin: float = 1e-6
    #: a factor is "failing"-indefinite when λmin < -psd_tol · |λmax|
    psd_tol: float = 1e-6
    #: max summed per-factor log10 condition number (the Kron kernel's
    #: condition is the product of the factors')
    max_log10_condition: float = 12.0
    #: consecutive chunks with ≥1 Armijo backtrack before "degraded"
    max_backtrack_streak: int = 3
    #: sampling: max fraction of truncated draws before "degraded"
    max_truncation_rate: float = 0.25
    #: sampling: max fraction of residual-mass-collapsed draws
    max_collapse_rate: float = 0.25
    #: sampling: consecutive flushes containing ≥1 truncation
    max_truncation_streak: int = 3


TrackerLike = Union[Tracker, Callable[[], Tracker], None]


class HealthMonitor:
    """Folds sentinel gauges into a ``healthy/degraded/failing`` verdict.

    tracker: a ``Tracker``, a zero-arg callable returning one (so the
        service can late-bind its per-call tee), or None for the
        process-wide tracker. Gauges/events are only emitted when the
        resolved tracker is enabled; the verdict works either way.
    component: tag stamped on every emission ("learning"/"sampling").
    """

    def __init__(self, thresholds: Optional[HealthThresholds] = None,
                 tracker: TrackerLike = None, component: str = "learning"):
        self.thresholds = thresholds or HealthThresholds()
        self._tracker = tracker
        self.component = component
        self.gauges: Dict[str, float] = {}
        self.triggered: Dict[str, float] = {}
        self.failing: Dict[str, float] = {}
        self.worst_verdict = "healthy"
        self._backtrack_streak = 0
        self._trunc_streak = 0
        self._drawn_total = 0
        self._truncated_total = 0
        self._collapsed_total = 0

    # -- plumbing ------------------------------------------------------------
    def _resolve(self) -> Tracker:
        t = self._tracker
        if t is None:
            return current_tracker()
        return t() if callable(t) else t

    def _gauge(self, name: str, value: float, *, soft_trip: bool = False,
               hard_trip: bool = False) -> None:
        value = float(value)
        self.gauges[name] = value
        if hard_trip:
            self.failing[name] = value
        else:
            self.failing.pop(name, None)
        if soft_trip or hard_trip:
            self.triggered[name] = value
        else:
            self.triggered.pop(name, None)
        tracker = self._resolve()
        if enabled(tracker):
            tracker.gauge(f"health.{name}", value, component=self.component)

    # -- verdict -------------------------------------------------------------
    @property
    def verdict(self) -> str:
        """CURRENT status — a later clean check clears an earlier trip;
        ``worst_verdict`` keeps the run's low-water mark."""
        if self.failing:
            return "failing"
        if self.triggered:
            return "degraded"
        return "healthy"

    _SEVERITY = {"healthy": 0, "degraded": 1, "failing": 2}

    def _note_verdict(self) -> str:
        v = self.verdict
        if self._SEVERITY[v] > self._SEVERITY[self.worst_verdict]:
            self.worst_verdict = v
        return v

    def report(self, emit: bool = True,
               tracker: Optional[Tracker] = None) -> dict:
        """A summary dict ``{verdict, component, gauges, triggered}``;
        with ``emit`` also pushed as one ``health.report`` event (to
        ``tracker`` when given, else the monitor's own sink)."""
        rep = {"verdict": self.verdict, "worst": self.worst_verdict,
               "component": self.component, "gauges": dict(self.gauges),
               "triggered": dict(self.triggered)}
        if emit:
            tracker = tracker if tracker is not None else self._resolve()
            if enabled(tracker):
                tracker.event("health.report", verdict=rep["verdict"],
                              component=self.component,
                              triggered=sorted(self.triggered),
                              **{k: v for k, v in self.gauges.items()})
        return rep

    # -- learning sentinels --------------------------------------------------
    def check_learning(self, params: Sequence, algorithm: str,
                       ll: Optional[float] = None, backtracks: int = 0
                       ) -> str:
        """Sentinels at a chunk boundary (host already synced).

        params: the engine's params — (L1, L2) factors for krk/joint,
            (lam, V) for em (whose λ spectrum IS the kernel spectrum).
        ll: the chunk's tracked log-likelihood, or None when untracked
            (``ll_mode="none"`` carries -inf in the state, which must
            NOT read as a failure).
        backtracks: Armijo backtracks taken during this chunk.
        """
        th = self.thresholds
        # host float64 copies; a CUDA tensor has no numpy view, so tensors
        # are read through .detach().cpu() first
        arrays = [np.asarray(p.detach().cpu() if hasattr(p, "detach")
                             else p, dtype=np.float64)
                  for p in (params[:1] if algorithm == "em" else params)]

        # A monitor must never take a fit down: nonfinite factors (or an
        # eigensolver that refuses them) are themselves the hardest
        # sentinel — flag and skip the spectral gauges.
        spectra = []
        params_bad = any(not np.isfinite(a).all() for a in arrays)
        if not params_bad:
            try:
                spectra = (arrays if algorithm == "em" else
                           [np.linalg.eigvalsh(a) for a in arrays])
            except np.linalg.LinAlgError:
                params_bad = True
        self._gauge("params_nonfinite", 1.0 if params_bad else 0.0,
                    hard_trip=params_bad)

        if spectra:
            min_eig = min(float(s.min()) for s in spectra)
            margins = []
            log_cond = 0.0
            indefinite = False
            for s in spectra:
                lo, hi = float(s.min()), float(s.max())
                scale = max(abs(hi), abs(lo), 1e-300)
                margins.append(lo / scale)
                if lo < -th.psd_tol * scale:
                    indefinite = True
                log_cond += (np.log10(hi / lo) if lo > 0 and hi > 0
                             else float("inf"))
            psd_margin = min(margins)

            self._gauge("min_eigenvalue", min_eig, hard_trip=indefinite)
            self._gauge("psd_margin", psd_margin,
                        soft_trip=psd_margin < th.min_psd_margin)
            self._gauge("log10_condition", log_cond,
                        soft_trip=log_cond > th.max_log10_condition)

        nonfinite = ll is not None and not np.isfinite(ll)
        self._gauge("ll_nonfinite", 1.0 if nonfinite else 0.0,
                    hard_trip=nonfinite)

        self._backtrack_streak = (self._backtrack_streak + 1
                                  if backtracks > 0 else 0)
        self._gauge("backtrack_streak", self._backtrack_streak,
                    soft_trip=self._backtrack_streak > th.max_backtrack_streak)
        return self._note_verdict()

    # -- sampling sentinels --------------------------------------------------
    def check_sampling(self, drawn: int, truncated: int, collapsed: int
                       ) -> str:
        """Sentinels at a flush boundary.

        drawn: samples scattered this flush; truncated: draws that hit
        the k_max budget; collapsed: draws whose phase-2 residual mass
        ran out early (fewer valid picks than requested).
        """
        th = self.thresholds
        self._drawn_total += int(drawn)
        self._truncated_total += int(truncated)
        self._collapsed_total += int(collapsed)
        total = max(self._drawn_total, 1)
        trunc_rate = self._truncated_total / total
        collapse_rate = self._collapsed_total / total
        self._trunc_streak = self._trunc_streak + 1 if truncated > 0 else 0

        self._gauge("truncation_rate", trunc_rate,
                    soft_trip=trunc_rate > th.max_truncation_rate)
        self._gauge("collapse_rate", collapse_rate,
                    soft_trip=collapse_rate > th.max_collapse_rate)
        self._gauge("truncation_streak", self._trunc_streak,
                    soft_trip=self._trunc_streak > th.max_truncation_streak)
        return self._note_verdict()
