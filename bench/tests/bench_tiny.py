"""Tiny cells for the CPU tests of the benchmark: each kind of request at a
size the CPU runs in a second, with the limits of the full cell's traffic
mix."""

import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from bench import harness  # noqa: E402

CPU = torch.device("cpu")


def _limits(traffic: str) -> dict:
    with open(ROOT / "bench" / "traffic" / f"{traffic}.json") as f:
        return json.load(f)["limits"]


def cells() -> dict:
    """Name -> Cell at a tiny size, with every end-to-end and per-layer
    metric of its full cell."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {}
    tiny = {
        "genes-sample": (
            {"factor_sizes": [6, 5], "expected_size": 3, "precision": "fp32"},
            {"kind": "kron_sample", "batch": 16, "checked": 2,
             "limits": _limits("keyed-batch-1024")}),
        "qwen2-0.5b-prune": (
            {"hidden_size": 16, "intermediate_size": 24,
             "num_hidden_layers": 2, "rms_norm_eps": 1e-6,
             "precision": "fp32"},
            {"kind": "ffn_prune", "probe": [2, 8], "keep_fraction": 0.5,
             "checked": 2, "limits": _limits("ffn-prune-probe")}),
        "genes-learn": (
            {"factor_sizes": [4, 3], "expected_size": 2,
             "precision": "fp32"},
            {"kind": "krk_learn", "subsets": 30, "k_max": 8, "chunk": 2,
             "step": 1.0, "checked": 1,
             "limits": _limits("krk-dense-sweeps")}),
    }
    for w in spec["workloads"]:
        full = harness.load_cell(w["name"], ROOT)
        cfg, tr = tiny[w["name"]]
        out[w["name"]] = harness.Cell(w["name"], cfg, tr, 1, full.end_to_end,
                                      full.per_layer)
    return out


def run(cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
        trace: bool = False):
    """(exit code, result line as a dict, standard error) of one run on
    the CPU."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, seconds, trace, CPU, time.perf_counter(),
                     out=out, err=err)
    line = out.getvalue().strip().splitlines()
    return rc, (json.loads(line[-1]) if line else None), err.getvalue()
