"""Each cell's set-up, window and result line at a tiny size on the CPU,
judged against the plain reference."""

import json

import pytest

import bench_tiny

CELLS = sorted(bench_tiny.cells())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    cell = bench_tiny.cells()[name]
    rc, res, err = bench_tiny.run(cell, trace=trace)
    assert rc == 0 and res is not None, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for c, v in res["checks"].items():
        assert v["value"] <= v["limit"], c
        assert f"check {c}:" in err
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert res["metrics"]["setup_s"]["value"] > 0
    else:
        assert res["device"]["window_s"] > 0
        assert "device_ops" in res["breakdown"]
    json.dumps(res, allow_nan=False)


def test_same_seed_same_answers():
    """Two runs of one seed judge the same requests alike: the inputs and
    the uniforms come from the seed alone."""
    cell = bench_tiny.cells()["genes-sample"]
    a = bench_tiny.run(cell, seed=5)[1]["checks"]
    b = bench_tiny.run(cell, seed=5)[1]["checks"]
    assert a == b


def test_a_name_split_by_cell_reads_its_stem():
    """``mfu.learn`` and ``mfu.draw`` have no file of their own: both are
    read by ``metrics/mfu.py``."""
    from bench import harness
    stem = harness._reader("metrics", "mfu")
    assert harness._reader("metrics", "mfu.learn").__code__.co_code == \
        stem.__code__.co_code
