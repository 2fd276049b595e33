"""repro_torch.obs — the metrics/tracing layer of the port.

Copies of the JAX package's ``obs/tracker.py``, ``obs/spans.py``,
``obs/health.py``, ``obs/export.py`` and ``obs/report.py`` (stdlib plus
numpy), kept here so that the port imports
nothing of the JAX package. Every metric and span name is the same as
there: ``service.device_calls``, ``spectral_cache.eigh_s``,
``kernels.phase2_select.<engine>``, ``health.*``.

The default sink is the zero-overhead ``NullTracker``; install another
with ``configure()`` or temporarily with ``use()``::

    import repro_torch.obs as obs
    with obs.use(obs.InMemoryTracker()) as t:
        model.sample(generator, 64)
    print(t.snapshot())

A JSONL run log (``configure(jsonl="run_log.jsonl")``) exports to
``chrome://tracing`` with ``ChromeTraceExporter`` and summarizes with
``python -m repro_torch.obs.report run_log.jsonl [--trace out.json]``.
"""

from . import export, health, spans
from .export import ChromeTraceExporter, read_run_log
from .health import HealthMonitor, HealthThresholds
from .spans import (NULL_SPAN, Span, current_span, emit_span, new_trace_id,
                    start_span)
from .tracker import (InMemoryTracker, JsonlTracker, NullTracker, TeeTracker,
                      Tracker, configure, current_tracker, enabled, tee, use)

__all__ = [
    "Tracker", "NullTracker", "InMemoryTracker", "JsonlTracker",
    "TeeTracker", "configure", "current_tracker", "enabled", "tee", "use",
    "spans", "Span", "start_span", "current_span", "emit_span",
    "new_trace_id", "NULL_SPAN",
    "health", "HealthMonitor", "HealthThresholds",
    "export", "ChromeTraceExporter", "read_run_log",
]
