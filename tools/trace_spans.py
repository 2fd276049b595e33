"""One traced run of a benchmark cell, with the breakdown by the program's
own spans that the result line does not carry.

    python3 tools/trace_spans.py --workload genes-sample --seed 7 \\
        [--seconds 50] [--out traces/spans-genes-sample.json]

Runs ``bench/run.py --trace 1`` in this process (its result line is
printed as usual), keeps the ``bench.trace.Trace`` it read, and writes a
JSON object: ``idle_labels``, the device's idle time by ``bench span /
program span / operation`` (``bench.program.idle_labels``); ``spans``,
each ``repro_torch.*`` span's count, host seconds and device seconds;
``syncs_by_span`` and ``allocs_by_span``, the blocking syncs and the
``cudaMalloc``/``cudaFree`` calls by the innermost span they ran in;
``device_shadows``, the device-row events named after a program span
(none when the program's regions cast no shadow there). Needs a card, as
``bench/run.py`` does.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import bench.trace as trace_mod
    from bench import program
    from bench import run as bench_run

    kept = []

    class Kept(trace_mod.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    trace_mod.Trace = Kept
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    if rc != 0 or not kept:
        return rc or 1
    t = kept[0]
    out = {"workload": args.workload, "seed": args.seed,
           "window_s": t.window_s, "busy_s": t.busy_s, "units": t.units,
           "idle_labels": program.idle_labels(t, None),
           "spans": program.span_table(t),
           "syncs_by_span": program.calls_by_span(t, program.SYNCS),
           "allocs_by_span": program.calls_by_span(t, program.ALLOCS),
           "device_shadows": sorted({n for _, _, n in t.device
                                     if n.startswith(program.PREFIX)})}
    path = Path(args.out) if args.out else \
        ROOT / "traces" / f"spans-{args.workload}-{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"spans: {args.workload} seed {args.seed} -> {path}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
