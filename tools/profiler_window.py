"""Does ``torch.profiler`` record every device launch of a window?

``chip_smoke.py`` reads kernel device times from ``torch.profiler`` and
requires, for the ``kron_matvec`` rows, exactly one recorded kernel per
call. This script profiles ``kron_matvec_cuda`` (100 × 100, batch 64,
float32) in windows of 100 calls and counts what each window recorded, in
three variants taken in turn, trial by trial:

- ``no_margin``: the calls start as soon as ``profile`` is entered;
- ``markers``: the same, with a fill kernel before the calls and a
  multiply kernel after them, to show which end of the window loses events;
- ``margin``: ``chip_smoke.PROFILER_MARGIN_S`` of host sleep before the
  first call and after the final sync, as ``chip_smoke.device_ms`` does.

Needs one CUDA card; builds ``csrc/kron_matvec.cu`` on first use. Run from
the root of the checkout:

    python3 tools/profiler_window.py [--trials 400]

Prints one JSON object: per variant, the number of windows that recorded
all 100 calls (and both markers), and the trials that did not, with what
they recorded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import PROFILER_MARGIN_S  # noqa: E402
from repro_torch.kernels import kron_matvec as km  # noqa: E402

REPS = 100


def window(fn, variant: str, marker: torch.Tensor) -> list:
    """Short names, in start order, of the device events one window
    recorded: K the kernel, F and M the markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if variant == "margin":
            time.sleep(PROFILER_MARGIN_S)
        if variant == "markers":
            marker.fill_(1.0)
        for _ in range(REPS):
            fn()
        if variant == "markers":
            marker.mul_(2.0)
        torch.cuda.synchronize()
        if variant == "margin":
            time.sleep(PROFILER_MARGIN_S)
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return ["K" if "kron_matvec" in e.name else
            "F" if "Fill" in e.name else
            "M" if "Mul" in e.name else e.name[:40] for e in dev]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_window: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((100, 100), generator=gen, device="cuda")
    B = torch.randn((100, 100), generator=gen, device="cuda")
    X = torch.randn((64, 10_000), generator=gen, device="cuda")
    marker = torch.zeros(1000, device="cuda")

    def fn():
        return km.kron_matvec_cuda(A, B, X)

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    want = {"no_margin": ["K"] * REPS, "margin": ["K"] * REPS,
            "markers": ["F"] + ["K"] * REPS + ["M"]}
    out = {v: {"complete": 0, "short": []} for v in want}
    for trial in range(args.trials):
        for variant, expected in want.items():
            names = window(fn, variant, marker)
            if names == expected:
                out[variant]["complete"] += 1
            else:
                out[variant]["short"].append(
                    {"trial": trial, "kernels": names.count("K"),
                     "first": names[:1], "last": names[-1:]})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "trials": args.trials, "calls_per_window": REPS,
                      "margin_s": PROFILER_MARGIN_S, **out}))


if __name__ == "__main__":
    main()
