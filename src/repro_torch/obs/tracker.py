"""Trackers: the metric/trace emission protocol and its sinks.

Four primitives cover everything the repo wants to observe:

  * ``counter(name, value=1, **tags)`` — monotone totals (device calls,
    cache hits, truncated draws);
  * ``gauge(name, value, **tags)`` — last-value-wins levels (current
    log-likelihood, accepted step size, batch occupancy);
  * ``observe(name, seconds, **tags)`` — one timer/histogram sample
    (flush latency, queue wait, eigh wall time); ``timer(name)`` is the
    context-manager spelling;
  * ``event(name, **fields)`` — structured one-off records (a fit
    finishing, a benchmark report).

``scope(**tags)`` pushes context tags (run id, tenant, shard) that are
merged into every emission made inside the ``with`` block.

Sinks:

``NullTracker``
    the zero-overhead default — every method is a constant-time no-op and
    ``timer``/``scope`` hand back one shared null context manager, so
    instrumented hot paths cost an attribute lookup and a call when
    nothing is listening.
``InMemoryTracker``
    aggregates in plain dicts (``counters`` / ``gauges`` /
    ``observations`` / ``events``) — the assertion surface for tests and
    the per-service accumulator behind ``ServiceStats``.
``JsonlTracker``
    append-only run log: one JSON object per emission, flushed per line,
    so a crashed run keeps every record up to the crash.
``TeeTracker``
    fans one emission out to several sinks (e.g. a service's private
    ``InMemoryTracker`` plus the process-wide run log).

Tracing note: tracker calls are HOST-side. PyTorch runs eagerly, so the
``kernels.ops`` dispatch counters fire once per executed call (the JAX
package's fire once per compiled specialization). Pass only names, tags
and python numbers, never tensors.

This module is a copy of the JAX package's ``obs/tracker.py`` (which is
stdlib-only); the metric and span names are the same in both packages.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple


class _NullContext:
    """Reusable no-op context manager (one shared instance, no per-use
    allocation)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()

#: per-thread scope-tag stacks, keyed by tracker id (see Tracker._push_tags)
_SCOPES = threading.local()


class Tracker:
    """The emission protocol. Subclasses override the four primitives;
    ``timer``/``scope`` are derived. Base methods are no-ops so a partial
    sink (e.g. counters-only) stays a valid tracker."""

    def counter(self, name: str, value: int = 1, **tags) -> None:
        pass

    def gauge(self, name: str, value: float, **tags) -> None:
        pass

    def observe(self, name: str, seconds: float, **tags) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def timer(self, name: str, **tags):
        """``with tracker.timer("flush_s"): ...`` — emits one ``observe``
        sample of the block's wall time on exit."""
        return _Timer(self, name, tags)

    def scope(self, **tags):
        """Push context tags merged into every emission in the block."""
        return _Scope(self, tags)

    # -- scope plumbing (overridden to a no-op in NullTracker) --------------
    # Tag stacks are PER THREAD (keyed per tracker in a threading.local):
    # a scope pushed on the main thread must not leak into emissions made
    # concurrently from a service flush thread, and an interleaved
    # push/pop from two threads must not corrupt either stack.
    def _push_tags(self, tags: Dict[str, Any]) -> None:
        stacks = getattr(_SCOPES, "stacks", None)
        if stacks is None:
            stacks = _SCOPES.stacks = {}
        stacks.setdefault(id(self), []).append(tags)

    def _pop_tags(self) -> None:
        stacks = _SCOPES.stacks
        key = id(self)
        stacks[key].pop()
        if not stacks[key]:
            del stacks[key]   # don't let dead trackers' ids accumulate

    def _merged(self, tags: Dict[str, Any]) -> Dict[str, Any]:
        stacks = getattr(_SCOPES, "stacks", None)
        stack = stacks.get(id(self)) if stacks else None
        if not stack:
            return tags
        out: Dict[str, Any] = {}
        for t in stack:
            out.update(t)
        out.update(tags)
        return out


class _Timer:
    __slots__ = ("_tracker", "_name", "_tags", "_t0")

    def __init__(self, tracker: Tracker, name: str, tags: Dict[str, Any]):
        self._tracker, self._name, self._tags = tracker, name, tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracker.observe(self._name, time.perf_counter() - self._t0,
                              **self._tags)
        return False


class _Scope:
    __slots__ = ("_tracker", "_tags")

    def __init__(self, tracker: Tracker, tags: Dict[str, Any]):
        self._tracker, self._tags = tracker, tags

    def __enter__(self):
        self._tracker._push_tags(self._tags)
        return self

    def __exit__(self, *exc):
        self._tracker._pop_tags()
        return False


class NullTracker(Tracker):
    """The default sink: nothing is recorded, nothing is allocated.

    ``timer``/``scope`` return one shared context manager, so even
    ``with tracker.timer(...)`` costs no allocation — the property the
    no-overhead test pins (see ``tests/test_obs.py``)."""

    def timer(self, name: str, **tags):
        return _NULL_CONTEXT

    def scope(self, **tags):
        return _NULL_CONTEXT


def enabled(tracker: Tracker) -> bool:
    """False for the zero-overhead default sink. Hot paths use this to
    skip emission-only work (e.g. a ``block_until_ready`` that exists
    purely to make a wall-clock measurement honest)."""
    return not isinstance(tracker, NullTracker)


class InMemoryTracker(Tracker):
    """Aggregating sink for tests and per-component stat views.

    ``counters``/``gauges`` aggregate BY NAME (tags folded away) — the
    shape the Local-vs-Mesh equivalence assertions compare; the full
    tagged stream is retained in ``records`` when ``keep_records=True``.
    Thread-safe (``SamplingService`` may be flushed from worker threads).
    """

    def __init__(self, keep_records: bool = False):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.observations: Dict[str, List[float]] = {}
        self.events: List[Dict[str, Any]] = []
        self.records: List[Dict[str, Any]] = []
        self._keep_records = keep_records

    def _record(self, kind: str, name: str, value, tags) -> None:
        if self._keep_records:
            self.records.append({"kind": kind, "name": name, "value": value,
                                 "tags": self._merged(tags)})

    def counter(self, name: str, value: int = 1, **tags) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value
            self._record("counter", name, value, tags)

    def gauge(self, name: str, value: float, **tags) -> None:
        with self._lock:
            self.gauges[name] = value
            self._record("gauge", name, value, tags)

    def observe(self, name: str, seconds: float, **tags) -> None:
        with self._lock:
            self.observations.setdefault(name, []).append(float(seconds))
            self._record("observe", name, seconds, tags)

    def event(self, name: str, **fields) -> None:
        with self._lock:
            self.events.append({"name": name, **self._merged(fields)})
            self._record("event", name, None, fields)

    # -- read side ----------------------------------------------------------
    def counter_value(self, name: str, default: float = 0) -> float:
        return self.counters.get(name, default)

    def percentile(self, name: str, p: float) -> float:
        """p in [0, 100] over the observed samples of ``name``."""
        xs = sorted(self.observations.get(name, ()))
        if not xs:
            return float("nan")
        i = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
        return xs[i]

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict summary (counters, gauges, per-timer count/sum/p50/
        p99) — what benchmarks embed in their JSON reports."""
        with self._lock:
            timers = {
                name: {"count": len(xs), "sum_s": sum(xs)}
                for name, xs in self.observations.items()}
        for name in timers:
            timers[name]["p50_s"] = self.percentile(name, 50)
            timers[name]["p99_s"] = self.percentile(name, 99)
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "timers": timers, "events": len(self.events)}


def _jsonable(x):
    """Coerce numpy/torch scalars (and anything else) into JSON territory."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    item = getattr(x, "item", None)       # numpy / 0-d torch scalars
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    tolist = getattr(x, "tolist", None)
    if callable(tolist):
        try:
            return _jsonable(tolist())
        except Exception:
            pass
    return str(x)


class JsonlTracker(Tracker):
    """Append-only run log: one JSON object per emission.

    Every record carries ``t`` (unix seconds), ``kind``, ``name`` and the
    merged scope tags; each line is flushed as written so the log is
    readable while the run is live and complete up to any crash. Read one
    back with ``[json.loads(l) for l in open(path)]``.

    Concurrency: the JSON line is serialized outside the lock, but the
    file write happens under it — records from the service flush thread
    and the main thread interleave whole-line, never mid-record (pinned
    by the multi-thread round-trip test in ``tests/test_obs_spans.py``).
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def _write(self, kind: str, name: str, payload: Dict[str, Any],
               tags: Dict[str, Any]) -> None:
        rec = {"t": round(time.time(), 6), "kind": kind, "name": name,
               **{k: _jsonable(v) for k, v in payload.items()}}
        tags = self._merged(tags)
        if tags:
            rec["tags"] = _jsonable(tags)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")

    def counter(self, name: str, value: int = 1, **tags) -> None:
        self._write("counter", name, {"value": value}, tags)

    def gauge(self, name: str, value: float, **tags) -> None:
        self._write("gauge", name, {"value": value}, tags)

    def observe(self, name: str, seconds: float, **tags) -> None:
        self._write("observe", name, {"seconds": seconds}, tags)

    def event(self, name: str, **fields) -> None:
        self._write("event", name, {"fields": fields}, {})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TeeTracker(Tracker):
    """Forward every emission to each child sink in order."""

    def __init__(self, children: Iterable[Tracker]):
        self.children: Tuple[Tracker, ...] = tuple(children)

    def counter(self, name: str, value: int = 1, **tags) -> None:
        for c in self.children:
            c.counter(name, value, **tags)

    def gauge(self, name: str, value: float, **tags) -> None:
        for c in self.children:
            c.gauge(name, value, **tags)

    def observe(self, name: str, seconds: float, **tags) -> None:
        for c in self.children:
            c.observe(name, seconds, **tags)

    def event(self, name: str, **fields) -> None:
        for c in self.children:
            c.event(name, **fields)


def tee(*trackers: Tracker) -> Tracker:
    """Combine sinks, dropping Null ones; collapses to a single child (or
    the NullTracker) when possible, so hot paths never pay fan-out for
    sinks that record nothing."""
    live = [t for t in trackers if enabled(t)]
    if not live:
        return _NULL
    if len(live) == 1:
        return live[0]
    return TeeTracker(live)


# ---------------------------------------------------------------------------
# The process-wide seam: obs.configure() / obs.current_tracker()
# ---------------------------------------------------------------------------

_NULL = NullTracker()
_CURRENT: Tracker = _NULL


def current_tracker() -> Tracker:
    """The process-wide tracker instrumented library code emits to.
    Defaults to the zero-overhead ``NullTracker``; swap it with
    ``configure`` (or temporarily with ``use``)."""
    return _CURRENT


def configure(tracker: Optional[Tracker] = None, *,
              jsonl: Optional[str] = None) -> Tracker:
    """Install the process-wide tracker and return the PREVIOUS one (so
    callers can restore it).

    ``configure()`` with no arguments resets to the ``NullTracker``;
    ``configure(jsonl=path)`` is shorthand for installing a
    ``JsonlTracker(path)``; ``configure(tracker, jsonl=path)`` tees them.
    """
    global _CURRENT
    sinks = []
    if tracker is not None:
        sinks.append(tracker)
    if jsonl is not None:
        sinks.append(JsonlTracker(jsonl))
    prev = _CURRENT
    _CURRENT = tee(*sinks) if sinks else _NULL
    return prev


@contextlib.contextmanager
def use(tracker: Tracker):
    """Temporarily install ``tracker`` as the process-wide tracker:

        with obs.use(obs.InMemoryTracker()) as t:
            model.sample(key, 64)
        assert t.counters["service.device_calls"] == ...
    """
    prev = configure(tracker)
    try:
        yield tracker
    finally:
        configure(prev)
