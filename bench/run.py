"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell on one machine's cards.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``. With ``--trace 0`` the last line of standard output is
a JSON object whose ``metrics`` are the cell's end-to-end metrics; with
``--trace 1`` a shorter window runs under ``torch.profiler`` and the
metrics are the cell's per-layer metrics, with the trace's ``breakdown``.
The comparison with the plain reference (``checks``, each number beside its
limit) comes last in that line and on standard error. Exits non-zero, with
no result, without the cards the cell asks for.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache stays at a fixed path in the checkout
    # (the port's nvcc builds go to build/kernels/ by themselves)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
