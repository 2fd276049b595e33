"""Terminal summary for a JSONL run log (a copy of
``repro/obs/report.py``; the text is the same for the same log).

    python -m repro_torch.obs.report run_log.jsonl [--traces K] [--top K]
                                             [--trace OUT.json]

Sections:
  * counters — final totals per counter name;
  * observations — count/total/mean per ``observe``/``timer`` series;
  * top spans — span ops ranked by total self-reported duration;
  * per-trace latency breakdown — the slowest K traces rendered as an
    indented span tree, each line showing duration and share of the
    trace's root span;
  * health — the last ``health.report`` event, if any.

``--trace OUT.json`` additionally writes a Chrome trace-event file
(see ``repro_torch.obs.export``) for the same log.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from .export import ChromeTraceExporter, is_span_record, read_run_log


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:8.3f}s "
    if seconds >= 1e-3:
        return f"{seconds * 1e3:8.3f}ms"
    return f"{seconds * 1e6:8.1f}µs"


def _span_forest(records: List[dict]) -> Dict[str, List[dict]]:
    """Group span records by trace id, each sorted by start time."""
    traces: Dict[str, List[dict]] = defaultdict(list)
    for rec in records:
        if is_span_record(rec):
            traces[str(rec["fields"]["trace"])].append(rec["fields"])
    for spans in traces.values():
        spans.sort(key=lambda f: f.get("ts", 0.0))
    return dict(traces)


def _trace_duration(spans: List[dict]) -> float:
    """Wall extent of a trace: last span end minus first span start."""
    start = min(f["ts"] for f in spans)
    end = max(f["ts"] + f["dur_s"] for f in spans)
    return end - start


def _render_trace(trace_id: str, spans: List[dict], out) -> None:
    total = _trace_duration(spans)
    print(f"trace {trace_id}  ({_fmt_s(total).strip()} wall, "
          f"{len(spans)} spans)", file=out)
    children: Dict[Optional[str], List[dict]] = defaultdict(list)
    by_id = {f.get("span"): f for f in spans}
    for f in spans:
        parent = f.get("parent")
        # Orphans (parent emitted to another sink / filtered out) hang
        # off the root level rather than disappearing.
        children[parent if parent in by_id else None].append(f)

    def walk(parent_id, depth):
        for f in children.get(parent_id, []):
            share = (f["dur_s"] / total * 100.0) if total > 0 else 100.0
            extra = "".join(
                f" {k}={v}" for k, v in f.items()
                if k not in ("op", "trace", "span", "parent", "ts", "dur_s"))
            print(f"  {'  ' * depth}{_fmt_s(f['dur_s'])} {share:5.1f}%  "
                  f"{f['op']}{extra}", file=out)
            walk(f.get("span"), depth + 1)

    walk(None, 0)


def render(records: List[dict], traces: int = 3, top: int = 10,
           out=None) -> None:
    out = out if out is not None else sys.stdout

    counters: Dict[str, float] = defaultdict(float)
    obs_stats: Dict[str, List[float]] = defaultdict(list)
    health_report = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "counter":
            counters[rec["name"]] += rec.get("value", 0)
        elif kind == "observe":
            obs_stats[rec["name"]].append(
                rec.get("seconds", rec.get("value", 0.0)))
        elif kind == "event" and rec.get("name") == "health.report":
            health_report = rec.get("fields")

    if counters:
        print("== counters ==", file=out)
        for name in sorted(counters):
            print(f"  {counters[name]:>12g}  {name}", file=out)

    if obs_stats:
        print("== observations ==", file=out)
        for name in sorted(obs_stats):
            vals = obs_stats[name]
            print(f"  {name}: n={len(vals)} total={sum(vals):.6g} "
                  f"mean={sum(vals) / len(vals):.6g}", file=out)

    forest = _span_forest(records)
    if forest:
        totals: Dict[str, List[float]] = defaultdict(list)
        for spans in forest.values():
            for f in spans:
                totals[f["op"]].append(f["dur_s"])
        print("== top spans (by total duration) ==", file=out)
        ranked = sorted(totals.items(), key=lambda kv: -sum(kv[1]))[:top]
        for op, durs in ranked:
            print(f"  {_fmt_s(sum(durs))} total  n={len(durs):<6d} "
                  f"mean={_fmt_s(sum(durs) / len(durs)).strip():>10s}  {op}",
                  file=out)

        print(f"== slowest {min(traces, len(forest))} of {len(forest)} "
              f"traces ==", file=out)
        slowest = sorted(forest.items(),
                         key=lambda kv: -_trace_duration(kv[1]))[:traces]
        for trace_id, spans in slowest:
            _render_trace(trace_id, spans, out)
    else:
        print("(no spans in log)", file=out)

    if health_report is not None:
        print("== health ==", file=out)
        print(f"  verdict: {health_report.get('verdict')}", file=out)
        for k, v in sorted(health_report.items()):
            if k != "verdict":
                print(f"  {k}: {v}", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a JSONL run log into a terminal summary.")
    parser.add_argument("run_log", help="path to a JsonlTracker run log")
    parser.add_argument("--traces", type=int, default=3,
                        help="number of slowest traces to break down")
    parser.add_argument("--top", type=int, default=10,
                        help="number of span ops in the top-spans table")
    parser.add_argument("--trace", metavar="OUT.json", default=None,
                        help="also export a Chrome trace-event file")
    args = parser.parse_args(argv)

    records = read_run_log(args.run_log)
    render(records, traces=args.traces, top=args.top)
    if args.trace:
        ChromeTraceExporter().export(args.run_log, args.trace)
        print(f"wrote Chrome trace: {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
