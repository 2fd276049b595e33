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
  first call and after the final sync, as ``chip_smoke.device_ms`` does;
- ``margin_markers``: the margin and the markers, to show which end of a
  window that has the margin loses events;
- ``long_margin``: ten times the margin;
- ``spin_marks``: no margin, a ``torch.cuda._sleep`` kernel just before the
  first call and just after the last (S): a window whose first and last
  events are the two marks must hold every call (``marked_complete``
  counts those that do, ``marked_short`` those that do not).

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


# variant -> (host sleep at each edge of the window, markers around the
# calls: None, "fill" (F before, M after) or "spin" (S before and after))
VARIANTS = {"no_margin": (0.0, None), "markers": (0.0, "fill"),
            "margin": (PROFILER_MARGIN_S, None),
            "margin_markers": (PROFILER_MARGIN_S, "fill"),
            "long_margin": (10 * PROFILER_MARGIN_S, None),
            "spin_marks": (0.0, "spin")}
EDGES = {None: ([], []), "fill": (["F"], ["M"]), "spin": (["S"], ["S"])}


def window(fn, variant: str, marker: torch.Tensor) -> list:
    """Short names, in start order, of the device events one window
    recorded: K the kernel, F and M the markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    margin, markers = VARIANTS[variant]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        if markers == "fill":
            marker.fill_(1.0)
        elif markers == "spin":
            torch.cuda._sleep(1000)
        for _ in range(REPS):
            fn()
        if markers == "fill":
            marker.mul_(2.0)
        elif markers == "spin":
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(margin)
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return ["K" if "kron_matvec" in e.name else
            "S" if "spin_kernel" in e.name else
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
    want = {v: EDGES[m][0] + ["K"] * REPS + EDGES[m][1]
            for v, (_, m) in VARIANTS.items()}
    out = {v: {"complete": 0, "short": []} for v in want}
    out["spin_marks"].update(marked_complete=0, marked_short=0)
    for trial in range(args.trials):
        for variant, expected in want.items():
            names = window(fn, variant, marker)
            if names == expected:
                out[variant]["complete"] += 1
            else:
                out[variant]["short"].append(
                    {"trial": trial, "kernels": names.count("K"),
                     "first": names[:1], "last": names[-1:]})
            if variant == "spin_marks" and names[:1] == names[-1:] == ["S"] \
                    and len(names) >= 2:
                key = ("marked_complete" if names == expected
                       else "marked_short")
                out[variant][key] += 1
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "trials": args.trials, "calls_per_window": REPS,
                      "margin_s": PROFILER_MARGIN_S, **out}))


if __name__ == "__main__":
    main()
