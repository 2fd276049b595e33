"""Request-level span tracing: the causal layer on top of the flat metrics.

The flat counters and timers answer "how much, how fast, on average"; spans
answer "where did THIS request spend its time". A ``Span`` is one timed
operation with causal identity:

  * ``trace_id`` — groups every span belonging to one logical request
    (a ``SampleTicket``'s life from ``submit()`` to scatter, one
    ``learning.fit``, one benchmark);
  * ``span_id`` / ``parent_id`` — the nesting edges, so a run log can be
    reassembled into a tree or a Chrome/Perfetto trace-event file (the
    JAX package's exporters read the same record shape).

A span has two sinks behind one gate. It is live when its tracker is
enabled or ``torch.profiler`` is recording in this process:

  * tracker enabled: finishing the span emits ONE ``event("span", ...)``
    record under its own name, so every sink (JSONL run log, in-memory,
    tee) captures traces with zero new plumbing;
  * profiler recording: the span also opens the profiler's region
    ``repro_torch.<name>`` (``_record_function``), so it lies on the
    profiler's timeline, the clock of the device's kernels, with the aten
    operations, CUDA runtime calls and kernels it makes nested under it;
  * neither: ``start_span`` returns the shared inert ``NULL_SPAN`` after
    one check and allocates nothing.

Spans synthesized after the fact with ``emit_span`` reach the tracker
only; ``profiler_region`` opens the profiler's half alone, for sites whose
tracker side is a counter (the kernel wrappers' dispatches).

Propagation is context-local (``contextvars``), so nested ``start_span``
calls inside one thread parent automatically:

    with obs.spans.start_span("request") as root:
        with obs.spans.start_span("device-call"):   # child of `root`
            ...

``contextvars`` do NOT cross thread boundaries on their own; code that
hops threads (the service flush path, future async batching loops)
carries the lineage explicitly — either pass ``parent=`` (a ``Span`` or
a ``(trace_id, span_id)`` pair) to ``start_span`` in the worker thread,
or synthesize the record after the fact with ``emit_span``. The
``SampleTicket`` pattern is the template: the ticket is stamped with
``trace_id``/span id at ``submit()`` and whichever thread runs
``flush()`` parents its work on those ids.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import time
from typing import Optional, Tuple, Union

import torch

from .tracker import Tracker, current_tracker, enabled

#: A span's name on the profiler's timeline is its own under this prefix.
PROFILER_PREFIX = "repro_torch."

#: True while ``torch.profiler`` (or the autograd profiler) records in this
#: process: the profiler's half of the span gate, a fraction of a
#: microsecond a call.
profiling = torch._C._autograd._profiler_enabled


def _record_function(name: str):
    """The profiler's region of the span ``name``: a region of function
    scope, as an operator's. ``torch.profiler.record_function`` opens one
    of user scope, which the profiler also projects onto the device's row
    as a ``gpu_user_annotation`` over the kernels it launched: a reader of
    the device's row would count that shadow as device work. Kernels
    launched straight under a function-scope region (the port's own, over
    ``ctypes``) are linked to it, so its device time reads off the trace."""
    return torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + name)

# ids are "<process prefix>-<counter>": unique within a process, and the
# prefix keeps ids from colliding when several processes append to one
# run log. itertools.count.__next__ is atomic under the GIL, so id
# allocation is thread-safe without a lock.
_PREFIX = f"{os.getpid() & 0xffff:04x}"
_NEXT = itertools.count(1)


def new_trace_id() -> str:
    """A fresh trace id (cheap: one counter bump + string format)."""
    return f"t{_PREFIX}-{next(_NEXT):x}"


def new_span_id() -> str:
    """A fresh span id."""
    return f"s{_PREFIX}-{next(_NEXT):x}"


#: the active span of the current logical context (thread/task-local)
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None)


def current_span() -> Optional["Span"]:
    """The innermost open ``Span`` of this context, or None. Capture it
    before handing work to another thread and pass it as ``parent=``
    there — that is the supported thread-hop spelling."""
    return _CURRENT.get()


class Span:
    """One timed operation. Use as a context manager (``start_span``):
    entering records the start (wall + monotonic) and installs the span
    as the context-local parent; exiting restores the previous parent
    and emits the ``event("span", ...)`` record through the tracker.
    Opened while the profiler records, it also spans a profiler region
    of the same extent."""

    __slots__ = ("tracker", "name", "trace_id", "span_id", "parent_id",
                 "tags", "ts", "_t0", "_token", "_region")

    def __init__(self, tracker: Tracker, name: str, trace_id: str,
                 parent_id: Optional[str], tags: dict,
                 profiled: bool = False):
        self.tracker = tracker
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.tags = tags
        self.ts = None          # wall-clock start (unix s), set on enter
        self._t0 = None         # monotonic start, set on enter
        self._region = _record_function(name) if profiled else None

    def __enter__(self) -> "Span":
        if self._region is not None:
            self._region.__enter__()
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        _CURRENT.reset(self._token)
        emit_span(self.tracker, self.name, trace_id=self.trace_id,
                  span_id=self.span_id, parent_id=self.parent_id,
                  ts=self.ts, dur_s=dur, **self.tags)
        if self._region is not None:
            self._region.__exit__(*exc)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id})")


class _NullSpan:
    """The shared inert span ``start_span`` hands back when nothing is
    listening: entering/exiting does nothing and its ids are None, so
    callers that thread ids onward degrade gracefully."""

    __slots__ = ()
    name = None
    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _ProfiledSpan(_NullSpan):
    """A span that only the profiler sees (no tracker listens): its
    profiler region, and None ids as ``NULL_SPAN`` has."""

    __slots__ = ("name", "_region")

    def __init__(self, name: str):
        self.name = name
        self._region = _record_function(name)

    def __enter__(self) -> "_ProfiledSpan":
        self._region.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._region.__exit__(*exc)
        return False

ParentLike = Union["Span", Tuple[str, Optional[str]], None]


def profiler_region(name: str) -> _NullSpan:
    """A span that only the profiler sees: the ``repro_torch.<name>``
    region while the profiler records, else ``NULL_SPAN`` after one check.
    For sites whose tracker side is a counter, such as the kernel
    wrappers' dispatches: no span record, and no trace of its own, per
    call."""
    return _ProfiledSpan(name) if profiling() else NULL_SPAN


def start_span(name: str, tracker: Optional[Tracker] = None,
               parent: ParentLike = None, trace_id: Optional[str] = None,
               **tags) -> Union[Span, _NullSpan]:
    """Open a span; returns a context manager.

    tracker: emission sink (default: the process-wide tracker). A
        ``NullTracker`` sink short-circuits to the shared ``NULL_SPAN``
        — no allocation, no contextvar writes — unless the profiler
        records, when the span is the profiler's region alone.
    parent: explicit lineage — a ``Span`` (e.g. one captured with
        ``current_span()`` before a thread hop) or a
        ``(trace_id, span_id)`` pair (the ``SampleTicket`` spelling).
        When omitted, the context-local current span of THIS thread is
        the parent; when there is none, a new root trace starts.
    trace_id: force a trace id (with no parent span id) — for adopting a
        request id minted elsewhere.
    """
    tracker = tracker if tracker is not None else current_tracker()
    if not enabled(tracker):
        return profiler_region(name)
    parent_span_id: Optional[str] = None
    if parent is not None:
        if isinstance(parent, tuple):
            parent_trace, parent_span_id = parent
        else:
            parent_trace, parent_span_id = parent.trace_id, parent.span_id
        if trace_id is None:
            trace_id = parent_trace
    elif trace_id is None:
        cur = _CURRENT.get()
        if cur is not None:
            trace_id, parent_span_id = cur.trace_id, cur.span_id
    if trace_id is None:
        trace_id = new_trace_id()
    return Span(tracker, name, trace_id, parent_span_id, tags, profiling())


def emit_span(tracker: Tracker, name: str, *, trace_id: str,
              span_id: Optional[str] = None, parent_id: Optional[str] = None,
              ts: float, dur_s: float, **tags) -> str:
    """Emit one span record directly (no context manager) — for spans
    whose timing was measured out-of-band, e.g. the per-ticket
    ``queue-wait``/``device-call``/``scatter`` children the service
    synthesizes after a coalesced flush. Returns the span id.

    The record shape is the one every exporter reads:
    ``event("span", op=<name>, trace=, span=, parent=, ts=<unix s>,
    dur_s=<seconds>, **tags)``.
    """
    sid = span_id if span_id is not None else new_span_id()
    tracker.event("span", op=name, trace=trace_id, span=sid,
                  parent=parent_id, ts=ts, dur_s=dur_s, **tags)
    return sid
