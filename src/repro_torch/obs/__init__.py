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

On the card, no tracker is needed to see where a call's time goes: while
``torch.profiler`` records, every span of the port (``spans.start_span``)
is also a ``repro_torch.<name>`` region on the profiler's timeline, the
clock of the device's kernels::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        model.sample(key, 1024)
    p.export_chrome_trace("trace.json")    # read the repro_torch.* regions

The benchmark reads the same regions: ``python3 bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace 1`` prints the program spans'
per-layer metrics and a breakdown of the device's idle time by what the
host was in, and ``python3 tools/trace_spans.py --workload <cell> --seed
<n>`` writes that idle time by benchmark span, program span and operation.
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
