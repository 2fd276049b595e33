"""Chrome/Perfetto trace export for JSONL run logs (a copy of
``repro/obs/export.py``, which is stdlib-only; the port keeps its own so
that it imports nothing of the JAX package).

``JsonlTracker`` writes one JSON record per line; span records (from
``repro_torch.obs.spans``) carry ``op/trace/span/parent/ts/dur_s`` in
their ``fields``. ``ChromeTraceExporter`` converts that log into the Chrome
trace-event format (the ``{"traceEvents": [...]}`` JSON object format),
loadable in ``chrome://tracing`` or https://ui.perfetto.dev:

  * each span becomes one complete event (``"ph": "X"``) with
    microsecond ``ts``/``dur`` relative to the earliest span in the file;
  * each trace id gets its own lane (``tid``) so concurrent requests
    render as parallel rows, with an ``"M"`` metadata event naming the
    lane after the trace id;
  * gauges optionally become counter events (``"ph": "C"``) so e.g.
    ``health.psd_margin`` or ``service.batch_occupancy`` plot as tracks
    under the spans that produced them.

Usage::

    python - <<'PY'
    from repro_torch.obs.export import ChromeTraceExporter
    ChromeTraceExporter().export("run_log.jsonl", "trace.json")
    PY

or through the CLI seam ``python -m repro_torch.obs.report run_log.jsonl
--trace out``. A run log of either package exports to the same JSON.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional


def read_run_log(path: str) -> List[dict]:
    """Parse a JSONL run log, skipping blank/corrupt lines."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def is_span_record(rec: dict) -> bool:
    if rec.get("kind") != "event" or rec.get("name") != "span":
        return False
    fields = rec.get("fields")
    return isinstance(fields, dict) and "trace" in fields and "dur_s" in fields


def _tags_match(rec: dict, tag_filter: Optional[dict]) -> bool:
    if not tag_filter:
        return True
    tags = rec.get("tags") or {}
    fields = rec.get("fields") or {}
    return all(tags.get(k) == v or fields.get(k) == v
               for k, v in tag_filter.items())


class ChromeTraceExporter:
    """Convert run-log records into Chrome trace-event JSON.

    tag_filter: only include records whose scope tags (or span fields)
        match every key — e.g. ``{"bench": "facade_api"}`` splits a
        multi-bench run log into per-bench traces.
    include_counters: also emit ``"C"`` counter events for gauges.
    """

    def __init__(self, tag_filter: Optional[dict] = None,
                 include_counters: bool = True):
        self.tag_filter = tag_filter
        self.include_counters = include_counters

    def convert(self, records: Iterable[dict]) -> dict:
        spans = [r for r in records
                 if is_span_record(r) and _tags_match(r, self.tag_filter)]
        gauges = [r for r in records
                  if r.get("kind") == "gauge" and _tags_match(r, self.tag_filter)
                  ] if self.include_counters else []
        if not spans and not gauges:
            return {"traceEvents": []}

        # Anchor everything on the earliest wall-clock timestamp so the
        # viewer timeline starts at ~0 regardless of when the run was.
        t_anchor = min([r["fields"]["ts"] for r in spans] +
                       [r["t"] for r in gauges])

        # One lane (tid) per trace id, ordered by first appearance.
        lanes: Dict[str, int] = {}
        events: List[dict] = []
        for rec in spans:
            f = rec["fields"]
            trace = str(f["trace"])
            tid = lanes.setdefault(trace, len(lanes) + 1)
            args = {k: v for k, v in f.items()
                    if k not in ("op", "trace", "span", "parent", "ts", "dur_s")}
            args.update({"trace": trace, "span": f.get("span"),
                         "parent": f.get("parent")})
            scope_tags = rec.get("tags") or {}
            args.update(scope_tags)
            events.append({
                "name": f["op"],
                "cat": "span",
                "ph": "X",
                "ts": (f["ts"] - t_anchor) * 1e6,
                "dur": max(f["dur_s"], 0.0) * 1e6,
                "pid": 1,
                "tid": tid,
                "args": args,
            })
        for trace, tid in lanes.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": f"trace {trace}"}})
        for rec in gauges:
            events.append({
                "name": rec["name"],
                "cat": "gauge",
                "ph": "C",
                "ts": (rec["t"] - t_anchor) * 1e6,
                "pid": 1,
                "args": {"value": rec.get("value")},
            })
        return {"traceEvents": events}

    def export(self, run_log_path: str, out_path: str) -> dict:
        """Read ``run_log_path``, write the trace-event file, return it."""
        trace = self.convert(read_run_log(run_log_path))
        with open(out_path, "w") as f:
            json.dump(trace, f)
        return trace
