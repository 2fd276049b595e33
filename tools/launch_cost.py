"""Host time of one ``threefry2x32`` launch and of its parts, against
``torch.rand``, on one card.

    python3 tools/launch_cost.py

A keyed request makes three ``threefry2x32`` launches (the split of the
service key, the rows' keys, ``split_uniform``) where a generator made two
``torch.rand``; their device time is a few microseconds, so what a request
pays for them is the host's time to launch them. Each line is the host time
of one call, averaged over 3000 calls between two device syncs (the
device is never the bottleneck at these sizes): ``torch.rand`` and
``torch.empty`` of 16 x 10^4 floats; the pieces of the wrapper
(``torch.cuda.current_stream``, ``torch.cuda.device``, the input checks,
the ctypes call alone); the wrapper; and the ``repro_torch.random`` calls
of the serving path. Prints one JSON line with the times in microseconds,
the card's name and its power limit. Host times vary between calls by up
to 2x: compare lines of one run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, n: int = 3000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/launch_cost.py needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random as prng
    from repro_torch.kernels import _build
    from repro_torch.kernels import threefry as tf
    dev = torch.device("cuda", 0)
    keys = prng.split(prng.PRNGKey(0, dev), 16)
    key = prng.PRNGKey(1, dev)
    lib = _build.load_library("threefry", tf.bind)
    out = torch.empty((16, 10_000), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    calls = {
        "torch.rand(16, 10^4)": lambda: torch.rand((16, 10_000), device=dev),
        "torch.empty(16, 10^4)": lambda: torch.empty((16, 10_000),
                                                     device=dev),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "with torch.cuda.device": device_context,
        "input checks": lambda: tf._check_cuda_inputs(keys, None, "uniform"),
        "ctypes launch alone": lambda: lib.threefry2x32_launch(
            keys.data_ptr(), None, out.data_ptr(), 16, 10_000, 2, 0.0, 1.0,
            stream, None, 0),
        "threefry2x32_cuda uniform (16, 10^4)": lambda: tf.threefry2x32_cuda(
            keys, 10_000, "uniform"),
        "random.split(key)": lambda: prng.split(key),
        "random.split(key, 16)": lambda: prng.split(key, 16),
        "random.split_uniform(16 keys, 10^4, 46)": lambda: prng.split_uniform(
            keys, 10_000, 46),
    }
    times = {name: host_us(fn) for name, fn in calls.items()}
    for name, us in times.items():
        print(f"{name:42s} {us:8.2f} us")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"launch_cost_us": times, "card": card}))


if __name__ == "__main__":
    main()
