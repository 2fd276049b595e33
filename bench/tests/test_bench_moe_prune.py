"""The mixture-of-experts pruning cell (kind ``moe_prune``) at a tiny size
on the CPU: its check passes on the port, and the TF32 control and each
planted fault come out not correct; its roofline counts by hand."""

import numpy as np
import pytest
import torch

import bench_tiny
from bench import control, faults, harness
from bench.roofline import greedy_map, moe_prune

NAME = "moonlight-16b-prune"


def _cell(**traffic):
    cell = bench_tiny.cells()[NAME]
    return harness.Cell(NAME, cell.config, {**cell.traffic, **traffic}, 1,
                        cell.end_to_end, cell.per_layer)


def test_the_port_passes_and_reads_its_metrics():
    rc, res, err = bench_tiny.run(_cell(), trace=True)
    assert rc == 0 and res["correct"] is True, (err, res)
    assert set(res["checks"]) == {"route_mismatch", "map_gap", "unjudged"}
    for m in ("mfu.moe", "device_idle_share.moe", "expert_rows_overhead"):
        assert m in res["metrics"], m
    assert res["metrics"]["expert_rows_overhead"]["value"] == 1.0
    # a CPU run has no device time: the device metrics read nothing
    for m in ("moe_route_ms", "unit_kernel_ms", "expert_map_roofline"):
        assert m not in res["metrics"], m


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["moe_prune"]))
def test_each_fault_fails(fault):
    cell = _cell()
    undo = faults.plant("moe_prune", fault)
    try:
        rc, res, err = bench_tiny.run(cell)
    finally:
        undo()
    assert rc == 0 and res["correct"] is False, (fault, res["checks"])


def test_the_faults_are_the_three_the_cell_must_catch():
    assert set(faults.FAULTS["moe_prune"]) == {
        "swapped_pick", "dropped_token", "softmax_routing"}


def test_the_tf32_control_fails_and_the_port_passes():
    """At the tiny size with more positions, so that TF32's rounding of
    the unit kernels' products moves a pick."""
    cell = _cell(documents=8, positions=256)
    r = control.readings(cell, 2 ** 31 + 7, 2, "tf32", True, True,
                         bench_tiny.CPU)
    limits = dict(cell.traffic["limits"], unjudged=0.0)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


def test_of_record_is_one_selection_a_matrix():
    """An (H, k) record counts as H single selections, and the shared
    selection as one more; the greedy-MAP cells' reader finds nothing in
    it."""
    picks = np.array([[3, 0, 1], [2, -1, -1]])
    rec = {"units": 1, "expert_size": 5, "expert_picks": picks,
           "shared_size": 7, "shared_picks": np.array([6, 1])}
    assert moe_prune.of_record(rec) == [greedy_map.work(5, 3, 3),
                                        greedy_map.work(5, 3, 1),
                                        greedy_map.work(7, 2, 2)]
    assert greedy_map.of_record(rec) == []
    assert moe_prune.of_record({"map_size": 5, "picks": picks[0]}) == []


def test_request_count_by_hand():
    # P = 2 positions, d = 3, E = 4, R = 4 routed rows, f = 2, fs = 5
    got = moe_prune.request(2, 3, 4, 4, 2, 5)
    routed = 4 * 4 * 3 * 2 + 6 * 4 * 2 + 3 * 4 * 2 + 2 * 4 * 2 * 2
    shared = 4 * 2 * 3 * 5 + 5 * 2 * 5 + 3 * 2 * 5 + 2 * 2 * 5 * 5
    assert got == 4 * 2 * 3 + 2 * 2 * 3 * 4 + routed + shared
    rec = {"routed_rows": 4, "expert_size": 2, "shared_size": 5,
           "expert_picks": np.array([[1, 0]]), "shared_picks": np.array([4])}
    assert moe_prune.flops(rec, 2, 3, 4) == got + \
        greedy_map.work(2, 2, 2)[0] + greedy_map.work(5, 1, 1)[0]


def test_same_seed_same_inputs():
    from bench import inputs_moe
    a = inputs_moe.moe_probes(5, 2, 3, 4, 3, 8, bench_tiny.CPU)
    b = inputs_moe.moe_probes(5, 2, 3, 4, 3, 8, bench_tiny.CPU)
    assert torch.equal(a, b)
    w = inputs_moe.moe_weights(5, 2, 8, 4, 6, 6, bench_tiny.CPU)
    assert w["w_gate"].shape == (2, 4, 8, 6)
    assert w["shared_up"].shape == (2, 8, 6)


RUN_CELL = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import conftest, bench_tiny
cell = bench_tiny.cells()[{name!r}]
for trace in (False, True):
    rc, res, err = bench_tiny.run(cell, seconds=0.1, trace=trace)
    assert rc == 0, err
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_the_cell_loads_no_jax():
    """``test_bench_imports``'s check for this cell: its runs load neither
    JAX nor the JAX package."""
    import json
    import subprocess
    import sys
    root = bench_tiny.ROOT
    code = RUN_CELL.format(src=str(root / "src"), root=str(root),
                           tests=str(root / "bench" / "tests"), name=NAME)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & set(harness.FORBIDDEN)
