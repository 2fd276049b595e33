"""Tiny cells for the cells that ``bench_tiny`` has no size for: its
``cells()`` is extended here, so that every test of this directory that
walks the cells (runs, traced runs, faults, imports) walks these too.

``TINY`` maps a cell of ``BENCHMARK.json`` to its configuration and
traffic at a size the CPU runs in a second, with the limits of the full
cell's traffic mix. ``bench_tiny.cells`` reads ``BENCHMARK.json`` through
its module's ``json``; while it runs, that reading leaves these cells out.
"""

import json

import bench_tiny
from bench import harness
from bench.kinds import moe_prune  # noqa: F401  (enters its faults)


def _traffic(name: str) -> dict:
    with open(bench_tiny.ROOT / "bench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


TINY = {
    "moonlight-16b-prune": (
        {"name": "moe-tiny", "hidden_size": 16, "moe_intermediate_size": 12,
         "n_routed_experts": 8, "num_experts_per_tok": 2,
         "n_shared_experts": 1, "scoring_func": "sigmoid",
         "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "routed_scaling_factor": 2.446,
         "rms_norm_eps": 1e-5, "num_hidden_layers": 3,
         "first_k_dense_replace": 1, "num_attention_heads": 2,
         "num_key_value_heads": 2, "vocab_size": 64, "precision": "fp32"},
        {**_traffic("moe-prune-probe"), "documents": 4, "positions": 32,
         "topics": 3}),
}


class _WithoutTiny:
    """``json`` as ``bench_tiny.cells`` uses it, with ``TINY``'s cells
    taken out of the workloads it reads."""
    load = staticmethod(json.load)
    dumps = staticmethod(json.dumps)

    @staticmethod
    def loads(text):
        spec = json.loads(text)
        spec["workloads"] = [w for w in spec["workloads"]
                             if w["name"] not in TINY]
        return spec


_cells = bench_tiny.cells


def cells() -> dict:
    bench_tiny.json = _WithoutTiny
    try:
        out = _cells()
    finally:
        bench_tiny.json = json
    for name, (cfg, tr) in TINY.items():
        full = harness.load_cell(name, bench_tiny.ROOT)
        out[name] = harness.Cell(name, cfg, tr, 1, full.end_to_end,
                                 full.per_layer)
    return out


bench_tiny.cells = cells
