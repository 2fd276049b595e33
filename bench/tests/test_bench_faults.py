"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (``bench.faults``), planted in the port at a
tiny size on the CPU (the harness's look for a card skipped), the rest of
the run as it is."""

import pytest

import bench_tiny
from bench import faults, harness

CASES = [(name, fault) for name, cell in sorted(bench_tiny.cells().items())
         for fault in sorted(faults.FAULTS[cell.traffic["kind"]])]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    cell = bench_tiny.cells()[name]
    undo = faults.plant(cell.traffic["kind"], fault)
    try:
        rc, res, err = bench_tiny.run(cell)
    finally:
        undo()
    assert rc == 0 and res is not None, err
    assert res["correct"] is False, res["checks"]


def test_faults_cover_every_kind():
    kinds = {c.traffic["kind"] for c in bench_tiny.cells().values()}
    assert kinds <= set(faults.FAULTS)
    assert harness.FORBIDDEN
