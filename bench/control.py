"""The readings that a cell's limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 \\
        [--requests R] [--precision tf32] [--program 1] [--control 1] \\
        [--fault NAME]

For each seed, in one process: the port's readings (set-up and warm-up as
in a run, then R requests or chunks through the window's own call, judged
as a run judges its window's) and the control's (the plain reference in
the port's place, in float32 with every matrix product at
``--precision``, judged the same way). With ``--fault``, the port's
readings are taken with that fault of ``faults.FAULTS`` planted. Prints
one JSON line a seed. The benchmark's runs never run this: a limit lies
above the port's readings and below the control's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def judged(cell, seed: int, recs):
    """(kept, last) of ``recs`` as a run keeps them: the seed's sample of
    the traffic's ``checked`` records, and the last."""
    from bench import harness
    kept = harness.Reservoir(int(cell.traffic.get("checked", 0)), seed)
    for r in recs:
        kept.offer(r)
    return kept.items, recs[-1]


def readings(cell, seed: int, requests: int, precision: str,
             program: bool, control: bool, device, fault: str = "") -> dict:
    import torch
    from bench import faults, harness
    kind = harness.kind_of(cell.traffic)
    ctx = harness.Context(cell.config, cell.traffic, int(seed), device)
    out = {"seed": seed}
    undo = faults.plant(cell.traffic["kind"], fault) if fault else None
    t0 = time.perf_counter()
    try:
        work = kind.Workload(ctx)
        if program:
            work.warm_up()
            recs = [work.call(i) for i in range(requests)]
    finally:
        if undo is not None:
            undo()
    if program:
        work.release()
        out["program"] = {c.name: c.value
                          for c in work.check(*judged(cell, seed, recs))}
        out["program_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        recs = work.control(requests, precision)
        out["control"] = {c.name: c.value
                          for c in work.check(*judged(cell, seed, recs))}
        out["control_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--precision", default="tf32")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("bench/control.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in args.seeds:
        print(json.dumps(readings(cell, s, args.requests, args.precision,
                                  bool(args.program), bool(args.control),
                                  dev, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
